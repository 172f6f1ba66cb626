"""The port's legacy allowances for the graftlint pass suite.

Counterpart of ``paddle_tpu/analysis/baseline.py``: per (file, rule,
symbol), how many findings are ACCEPTED.  The runner marks exactly that
many as ``baselined``; the next occurrence of the same pattern in the
same file — new code repeating the habit — is an active finding and
fails the run.  Counts are stable under unrelated edits (line numbers
are not), which is why the key is the symbol, not the location.

Shrink-only: when the code is cleaned up, lower or delete its entry.
Never grow an entry to cover new code — new code gets fixed, or in a
justified case an inline ``# graftlint: allow=`` with its reason.
"""

#: rule name -> {(repo-relative path, finding key): allowed count}
BASELINE = {
    "determinism": {
        # host-side deadline polling in the process launcher, the
        # spawner, the elastic monitor and auto-checkpoint's intervals:
        # they steer processes, never the replayed serving decisions
        ("paddle_tpu_torch/distributed/launch_utils.py", "time.time"): 4,
        ("paddle_tpu_torch/distributed/spawn.py", "time.monotonic"): 2,
        ("paddle_tpu_torch/distributed/fleet/elastic.py", "time.time"): 1,
        ("paddle_tpu_torch/incubate/auto_checkpoint.py", "time.time"): 3,
        # the examples' tokens/s lines and the progress bar's ETA:
        # display-only wall clocks
        ("paddle_tpu_torch/examples/pretrain_bert.py", "time.time"): 2,
        ("paddle_tpu_torch/examples/train_deepfm.py", "time.time"): 2,
        ("paddle_tpu_torch/examples/train_vit.py", "time.time"): 2,
        ("paddle_tpu_torch/hapi/progressbar.py", "time.time"): 1,
        # TF event-file records require real walltime stamps
        ("paddle_tpu_torch/utils/tensorboard.py", "time.time"): 3,
        # the vision transforms draw from the global `random` module as
        # the reference's do (augmentation semantics)
        ("paddle_tpu_torch/vision/transforms/__init__.py",
         "random.randint"): 4,
        ("paddle_tpu_torch/vision/transforms/__init__.py",
         "random.uniform"): 5,
        ("paddle_tpu_torch/vision/transforms/__init__.py",
         "random.random"): 2,
        ("paddle_tpu_torch/vision/transforms/__init__.py",
         "random.shuffle"): 1,
        ("paddle_tpu_torch/vision/transforms/__init__.py",
         "random.choice"): 1,
        # the io / reader shufflers follow the reference's global seed
        ("paddle_tpu_torch/reader/__init__.py", "random.shuffle"): 2,
        ("paddle_tpu_torch/io/__init__.py", "numpy.random.permutation"): 2,
        ("paddle_tpu_torch/io/__init__.py", "numpy.random.randint"): 1,
        ("paddle_tpu_torch/io/__init__.py", "numpy.random.choice"): 1,
        # the RNG tracker's default seeds when the user gives none
        ("paddle_tpu_torch/distributed/fleet/meta_parallel/mp_layers.py",
         "random.randrange"): 2,
    },
    "host-sync": {
        # Python scalars of the launch (scale, causal, window, the flags):
        # host values, not device ones; a capture keeps them
        ("paddle_tpu_torch/kernels/flash.py", "float"): 2,
        ("paddle_tpu_torch/kernels/flash.py", "int"): 4,
        ("paddle_tpu_torch/kernels/flash.py", "bool"): 3,
        ("paddle_tpu_torch/kernels/paged_attention.py", "float"): 1,
        ("paddle_tpu_torch/kernels/paged_attention.py", "int"): 1,
        # the prefill chunk's start and lengths: host ints from the
        # engine
        ("paddle_tpu_torch/kernels/paged_prefill.py", "int"): 3,
        # AdamW's bias corrections, numpy fp32 scalars of the host's step
        # count (host values)
        ("paddle_tpu_torch/models/gpt.py", "float"): 2,
        # the verify step hands its predicted tokens to the host (one
        # sync a step): what a graph capture of speculative decoding must
        # move behind an event, as decode's double buffering does
        ("paddle_tpu_torch/serving/engine.py", "cpu"): 1,
        ("paddle_tpu_torch/serving/engine.py", "numpy"): 1,
    },
}
