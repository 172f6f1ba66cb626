"""``fluid.contrib.slim.quantization``: ``ImperativeQuantAware`` and
``ImperativePTQ``, which come with ``incubate.quant`` (ROADMAP A.12)."""


def _waits(name):
    class _Waits:
        def __init__(self, *a, **k):
            raise NotImplementedError(
                f"fluid.contrib.slim.quantization.{name} needs "
                f"paddle.incubate.quant, which the port gains with ROADMAP "
                f"A.12")

    _Waits.__name__ = name
    return _Waits


ImperativePTQ = _waits("ImperativePTQ")
ImperativeQuantAware = _waits("ImperativeQuantAware")
