"""The seed chain: explicit ``torch.Generator``s from a chain of keys.

Counterpart of ``paddle_tpu/framework/random.py`` (``seed``,
``next_rng_key``, ``trace_rng_scope``).  The reference threads JAX PRNG
keys; here a key is a 64-bit integer, split and folded by the splitmix64
finaliser, and every draw seeds a fresh ``torch.Generator`` from its key
(:func:`generator`).  So a draw depends on its key alone, never on how
many draws came before it on some global generator: a block recomputed
under ``torch.utils.checkpoint`` (which restores only the default
generators) draws the same numbers again from the same key.

The chain mirrors the reference's decisions: :func:`seed` re-anchors it,
:func:`next_rng_key` splits off a fresh key (from the innermost
:class:`trace_rng_scope` when one is open, else from the global chain),
and :func:`fold_in` derives a key from a key and an integer, as
``jax.random.fold_in`` does.  The keys are not JAX's: the same seed gives
other numbers here, so tests that compare the two packages hand both the
same uniforms (:func:`uniform` is the one draw function).
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence

import torch

_state = threading.local()
_DEFAULT_SEED = 0
_MASK = (1 << 64) - 1


def _mix(z: int) -> int:
    """The splitmix64 finaliser: a bijection of 64-bit integers whose
    outputs of consecutive inputs look independent."""
    z = (z + 0x9E3779B97F4A7C15) & _MASK
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
    return z ^ (z >> 31)


def make_key(s: int) -> int:
    """The key of seed ``s`` (``jax.random.PRNGKey``'s role)."""
    return _mix(int(s) & _MASK)


def fold_in(key: int, data: int) -> int:
    """A key derived from ``key`` and the integer ``data``."""
    return _mix(key ^ _mix((int(data) + 0x632BE59BD9B4E019) & _MASK))


def split(key: int):
    """Two fresh keys from ``key``: (the chain's next key, a subkey)."""
    return fold_in(key, 0), fold_in(key, 1)


def seed(s: int) -> int:
    """Re-anchor the chain at seed ``s`` (``paddle.seed``); returns the
    chain's key."""
    global _DEFAULT_SEED
    _DEFAULT_SEED = int(s)
    _state.key = make_key(s)
    return _state.key


class trace_rng_scope:
    """Draw keys from ``key`` inside the scope: a train step installs its
    per-step key here, and every draw inside splits off that key's chain,
    so each step draws fresh keys while the global chain stays where it
    was."""

    def __init__(self, key: int):
        self._key = key

    def __enter__(self):
        self._prev = getattr(_state, "trace_key", None)
        _state.trace_key = self._key
        return self

    def __exit__(self, *exc):
        _state.trace_key = self._prev
        return False


def next_rng_key() -> int:
    """A fresh key: split off the open scope's chain, else the global
    one (anchored at the default seed until :func:`seed` is called)."""
    tk = getattr(_state, "trace_key", None)
    if tk is not None:
        tk, sub = split(tk)
        _state.trace_key = tk
        return sub
    key = getattr(_state, "key", None)
    if key is None:
        key = make_key(_DEFAULT_SEED)
    key, sub = split(key)
    _state.key = key
    return sub


def get_rng_state() -> int:
    """The global chain's key (what :func:`next_rng_key` splits next)."""
    key = getattr(_state, "key", None)
    return make_key(_DEFAULT_SEED) if key is None else key


def set_rng_state(key: int) -> None:
    """Put the global chain at ``key`` (from :func:`get_rng_state`)."""
    _state.key = int(key)


def get_chain_state():
    """Where the draws stand: (the global chain's key, the open
    :class:`trace_rng_scope`'s key or None).  A replay that restores it
    (:func:`set_chain_state`) draws the same keys again."""
    return get_rng_state(), getattr(_state, "trace_key", None)


def set_chain_state(state) -> None:
    """Put the draws back where :func:`get_chain_state` found them."""
    key, trace_key = state
    set_rng_state(key)
    _state.trace_key = trace_key


def generator(key: int, device) -> Optional[torch.Generator]:
    """A ``torch.Generator`` on ``device`` seeded with ``key``; None on
    the ``meta`` device, where shape inference runs a kernel and nothing
    is drawn."""
    if torch.device(device).type == "meta":
        return None
    return torch.Generator(device=device).manual_seed(int(key))


class ShardedKey:
    """A key whose draws are this rank's part of a larger draw: ``parts``
    maps a dim of the drawn shape to ``(index, count)``, this draw being
    part ``index`` of ``count`` equal consecutive parts along it.  The
    distributed train step hands one to each dropout site, so a rank's
    mask is its slice (its batch rows, its heads) of the mask the whole
    model draws on one device."""

    def __init__(self, key: int, parts):
        self.key = key
        self.parts = dict(parts)


def draw(key, shape: Sequence[int], device) -> torch.Tensor:
    """:func:`uniform` of ``key`` over ``shape``; for a
    :class:`ShardedKey` the uniforms of the whole shape, sliced to this
    rank's part."""
    if not isinstance(key, ShardedKey):
        return uniform(key, shape, device)
    full, index = list(shape), [slice(None)] * len(shape)
    for dim, (i, n) in key.parts.items():
        full[dim] = shape[dim] * n
        index[dim] = slice(i * shape[dim], (i + 1) * shape[dim])
    return uniform(key.key, full, device)[tuple(index)]


def uniform(key: Optional[int], shape: Sequence[int], device) -> torch.Tensor:
    """fp32 uniforms in [0, 1) of ``shape`` on ``device``, drawn from
    :func:`generator` of ``key``: the one draw of the port's dropout."""
    return torch.rand(tuple(shape), generator=generator(key, device),
                      device=device, dtype=torch.float32)
