"""``python -m paddle_tpu_torch.distributed.fleet.launch``: the reference's
module path of the launcher (:mod:`paddle_tpu_torch.distributed.launch`).

Counterpart of ``paddle_tpu/distributed/fleet/launch.py``.
"""

from ..launch import launch, main  # noqa: F401

if __name__ == "__main__":
    main()
