"""``fluid.contrib.mixed_precision``: AMP for v2.1 scripts, over the 2.x
``amp`` (``decorate``, ``auto_cast``, ``GradScaler``)."""

from ....amp import GradScaler, auto_cast, decorate  # noqa: F401


class CustomOpLists:
    def __init__(self, custom_white_list=None, custom_black_list=None):
        self.white_list = set(custom_white_list or [])
        self.black_list = set(custom_black_list or [])


AutoMixedPrecisionLists = CustomOpLists
