"""``paddle.inference``: the deployment ``Config`` and ``Predictor``.

Counterpart of ``paddle_tpu/inference/__init__.py``.  A Predictor loads a
saved inference program (``jit.save`` / ``static.save_inference_model``,
of either package) and runs it on the static Executor, whose ops launch
the port's kernels on the card (the attention op the flash forward,
``quantized_matmul`` the int8 GEMM).  ``Config``'s device is the card
unless ``disable_gpu()`` asks for the CPU; ``enable_tpu`` raises.
``enable_bf16`` runs ``static.amp.rewrite_program`` on the loaded
program, and ``enable_int8`` (or ``enable_tensorrt_engine`` at
``PrecisionType.Int8``) the int8 rewrite of
:mod:`paddle_tpu_torch.static.quant_int8`.  The zero-copy ``Tensor``
handles take numpy in and give numpy out; ``run([...])`` also takes
Tensors or torch tensors already on the device, which are fed without a
trip through the host.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..jit import _feed_value

__all__ = ["Config", "Predictor", "Tensor", "create_predictor",
           "PrecisionType", "PlaceType"]


class PrecisionType:
    Float32 = 0
    Half = 1
    Bfloat16 = 2
    Int8 = 3


class PlaceType:
    CPU = 0
    GPU = 1
    TPU = 2
    XPU = 3


class Config:
    """``AnalysisConfig``: the model's path and the switches.  The knobs of
    subsystems the port does not have (memory optimisation, IR passes,
    MKLDNN) are recorded, so deployment scripts run unchanged."""

    def __init__(self, prog_file: Optional[str] = None,
                 params_file: Optional[str] = None):
        # paddle 2.x convention: Config("path/prefix") with combined files
        self._prog_file = prog_file
        self._params_file = params_file
        self._prefix = None
        if prog_file is not None and params_file is None:
            self._prefix = prog_file
        elif prog_file is not None and prog_file.endswith(".pdmodel.json"):
            self._prefix = prog_file[: -len(".pdmodel.json")]
        self._device = "gpu"
        self._device_id = 0
        self._amp = None
        self._opts: Dict[str, object] = {}

    # -- model location -------------------------------------------------
    def set_model(self, prog_file, params_file=None):
        self.__init__(prog_file, params_file)

    def prog_file(self):
        return self._prog_file

    def params_file(self):
        return self._params_file

    def model_dir(self):
        return self._prefix

    # -- device ----------------------------------------------------------
    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0):
        self._device, self._device_id = "gpu", device_id

    def enable_tpu(self, device_id=0):
        raise RuntimeError("Config.enable_tpu: the port runs on the GPU "
                           "(the default) or, after disable_gpu(), the CPU")

    def disable_gpu(self):
        self._device = "cpu"

    def use_gpu(self):
        return self._device == "gpu"

    # -- precision and graph options -------------------------------------
    def enable_memory_optim(self, *a, **k):
        self._opts["memory_optim"] = True

    def switch_ir_optim(self, flag=True):
        self._opts["ir_optim"] = flag

    def enable_mkldnn(self):
        self._opts["mkldnn"] = True

    def set_cpu_math_library_num_threads(self, n):
        self._opts["cpu_threads"] = n

    def enable_tensorrt_engine(self, *a, precision_mode=PrecisionType.Float32,
                               **k):
        # the engine's precision: bf16 is the amp rewrite, int8 the
        # quantized-matmul rewrite
        self._amp = ("bfloat16" if precision_mode in
                     (PrecisionType.Half, PrecisionType.Bfloat16) else None)
        if precision_mode == PrecisionType.Int8:
            # the user chose the int8 engine: no size gate (enable_int8()
            # keeps it)
            self._int8 = True
            self._int8_min_elements = 0

    def enable_bf16(self):
        self._amp = "bfloat16"

    def enable_int8(self, min_weight_elements: int = 1 << 16,
                    quantize_convs: bool = False):
        """Run the weight matmuls (and, with ``quantize_convs``, the convs)
        as int8 x int8 products summed in int32 (the rewrite of
        :mod:`paddle_tpu_torch.static.quant_int8`).  ``min_weight_elements``
        keeps smaller layers in float; 0 quantizes every matmul."""
        self._int8 = True
        self._int8_min_elements = int(min_weight_elements)
        self._int8_convs = bool(quantize_convs)

    def summary(self):
        return {"model": self._prefix, "device": self._device,
                "amp": self._amp, "int8": getattr(self, "_int8", False),
                **self._opts}


class Tensor:
    """``ZeroCopyTensor``: a named input or output handle."""

    def __init__(self, name: str, predictor: "Predictor", is_input: bool):
        self.name = name
        self._pred = predictor
        self._is_input = is_input

    def copy_from_cpu(self, arr: np.ndarray) -> None:
        assert self._is_input, f"{self.name} is an output handle"
        self._pred._feeds[self.name] = np.asarray(arr)

    def copy_to_cpu(self) -> np.ndarray:
        assert not self._is_input, f"{self.name} is an input handle"
        return _numpy(self._pred._results[self.name])

    def shape(self) -> List[int]:
        if self._is_input:
            a = self._pred._feeds.get(self.name)
        else:
            a = self._pred._results.get(self.name)
        return list(a.shape) if a is not None else []

    def reshape(self, shape) -> None:  # reference API; shapes are dynamic
        pass


class Predictor:
    """``AnalysisPredictor``: ``run()`` over named zero-copy handles, on
    the static Executor of the config's device (its prepared program
    cached per feed signature)."""

    def __init__(self, config: Config):
        from ..framework.place import CPUPlace, CUDAPlace
        from ..framework.scope import Scope
        from ..static.executor import Executor
        from ..static.io import load_inference_model

        self._config = config
        self._scope = Scope()
        self._exe = Executor(CPUPlace() if config._device == "cpu"
                             else CUDAPlace(config._device_id))
        prefix = config.model_dir() or config.prog_file()
        if prefix is None:
            raise ValueError("Config has no model path; call set_model()")
        self._program, self._feed_names, self._fetch_names = \
            load_inference_model(prefix, self._exe, scope=self._scope)
        if config._amp == "bfloat16":
            from ..static.amp import rewrite_program

            rewrite_program(self._program)
        if getattr(config, "_int8", False):
            from ..static.quant_int8 import rewrite_program_int8

            self._n_int8 = rewrite_program_int8(
                self._program, self._scope,
                fetch_names=list(self._fetch_names),
                min_weight_elements=getattr(
                    config, "_int8_min_elements", 1 << 16),
                quantize_convs=getattr(config, "_int8_convs", False))
        self._feeds: Dict[str, np.ndarray] = {}
        self._results: Dict[str, np.ndarray] = {}

    # -- handles ----------------------------------------------------------
    def get_input_names(self) -> List[str]:
        return list(self._feed_names)

    def get_output_names(self) -> List[str]:
        return list(self._fetch_names)

    def get_input_handle(self, name: str) -> Tensor:
        assert name in self._feed_names, name
        return Tensor(name, self, is_input=True)

    def get_output_handle(self, name: str) -> Tensor:
        assert name in self._fetch_names, name
        return Tensor(name, self, is_input=False)

    # -- execution --------------------------------------------------------
    def run(self, inputs: Optional[List[np.ndarray]] = None):
        """``run()`` after ``copy_from_cpu``, or ``run([arr, ...])``
        returning the outputs (numpy).  An input that is a Tensor or a
        torch tensor on the predictor's device is fed as it is."""
        return [_numpy(o) for o in self.run_on_device(inputs)]

    def run_on_device(self, inputs: Optional[List] = None):
        """:meth:`run` whose outputs stay on the device (port Tensors)."""
        if inputs is not None:
            for name, arr in zip(self._feed_names, inputs):
                self._feeds[name] = _feed_value(arr)
        missing = [n for n in self._feed_names if n not in self._feeds]
        if missing:
            raise RuntimeError(f"inputs not set: {missing}")
        outs = self._exe.run(self._program, feed=dict(self._feeds),
                             fetch_list=list(self._fetch_names),
                             scope=self._scope, return_numpy=False)
        self._results = dict(zip(self._fetch_names, outs))
        return outs

    def clone(self) -> "Predictor":
        return Predictor(self._config)


def create_predictor(config: Config) -> Predictor:
    """``paddle_infer.create_predictor``."""
    return Predictor(config)


def _numpy(v):
    """A fetched value (a port Tensor) as numpy."""
    return v.numpy() if hasattr(v, "numpy") else np.asarray(v)
