"""``paddle.fluid.initializer``: the v2.1 initializer names (Constant,
Uniform, Normal, TruncatedNormal, Xavier, MSRA, the ``*Initializer``
aliases and ``set_global_initializer``) over the 2.x initializers."""

import abc

from ..nn import initializer as _init

Constant = ConstantInitializer = _init.Constant
Uniform = UniformInitializer = _init.Uniform
Normal = NormalInitializer = _init.Normal
TruncatedNormal = TruncatedNormalInitializer = _init.TruncatedNormal


class _CompatInitMeta(abc.ABCMeta):
    """The metaclass of the v2.1 names: ``__call__`` builds the matching
    2.x initializer, and ABCMeta's ``register`` makes that a virtual
    subclass, so ``isinstance(Xavier(), Xavier)`` and
    ``isinstance(XavierUniform(), Xavier)`` both hold."""

    def __call__(cls, *args, **kwargs):
        if "_build" in vars(cls):  # the compat class itself, not a subclass
            return cls._build(*args, **kwargs)
        return super().__call__(*args, **kwargs)


class Xavier(_init.Initializer, metaclass=_CompatInitMeta):
    """v2.1's XavierInitializer: ``uniform=True`` by default (2.x splits
    it into XavierUniform / XavierNormal)."""

    @staticmethod
    def _build(uniform=True, fan_in=None, fan_out=None, seed=0):
        impl = _init.XavierUniform if uniform else _init.XavierNormal
        return impl(fan_in=fan_in, fan_out=fan_out)


Xavier.register(_init.XavierUniform)
Xavier.register(_init.XavierNormal)


class MSRA(_init.Initializer, metaclass=_CompatInitMeta):
    """v2.1's MSRAInitializer: ``uniform=True`` by default."""

    @staticmethod
    def _build(uniform=True, fan_in=None, seed=0, negative_slope=0.0,
               nonlinearity="relu"):
        impl = _init.KaimingUniform if uniform else _init.KaimingNormal
        return impl(fan_in=fan_in, negative_slope=negative_slope,
                    nonlinearity=nonlinearity)


MSRA.register(_init.KaimingUniform)
MSRA.register(_init.KaimingNormal)


XavierInitializer = Xavier
MSRAInitializer = MSRA
Bilinear = BilinearInitializer = getattr(_init, "Bilinear", None)
NumpyArrayInitializer = _init.Assign

set_global_initializer = _init.set_global_initializer

if Bilinear is None:
    def _bilinear_unavailable(*a, **k):
        raise NotImplementedError(
            "Bilinear initializer: initialize conv-transpose weights with "
            "an explicit numpy kernel + initializer.Assign")

    Bilinear = BilinearInitializer = _bilinear_unavailable
