"""``paddle.fluid.executor``: ``Executor`` and the scopes."""

from ..framework.scope import Scope, global_scope, scope_guard  # noqa: F401
from ..static.executor import Executor  # noqa: F401
