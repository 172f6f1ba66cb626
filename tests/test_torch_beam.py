"""The port's beam search (``paddle_tpu_torch.models.build_beam_search_fn``)
against the reference's ``build_beam_search_fn``, token for token.

Same weights (``torch_parity.pair``), same prompts, fp32 on the CPU:
float and W8A8 (int8 projections over ``(values, scales)`` caches), with
and without the GNMT length penalty, and with ``eos_token_id`` set to a
token the model emits early, so that frozen beams (exact ties of -inf and
of equal scores) decide the selection.  ``beam_size=1`` equals greedy
decoding.  Exact equality is the contract: both sides pick among the same
fp32 log-probs with the same tie order (the lower index first).

Model: ``torch_parity.py``'s (vocab 512, hidden 64, 2 layers, 2 heads).
"""

import numpy as np
import pytest

from paddle_tpu.models import generation as jgen
from paddle_tpu_torch.models import build_beam_search_fn, generate
from torch_parity import pair


def _ids(seed=0, b=2, t=7):
    return np.random.RandomState(seed).randint(0, 512, (b, t)).astype(
        np.int32)


def _both(jm, tm, ids, new, **kw):
    ref = np.asarray(jgen.build_beam_search_fn(jm, new, **kw)(ids))
    got = build_beam_search_fn(tm, new, **kw)(ids).numpy()
    return got, ref


@pytest.mark.parametrize("kw", [
    dict(beam_size=4),
    dict(beam_size=4, length_penalty=0.6),
    dict(beam_size=3, int8=True),
    dict(beam_size=2, length_penalty=1.0, int8=True),
], ids=["float", "float-lp", "int8", "int8-lp"])
def test_beam_search_matches_reference(kw):
    jm, tm = pair(seed=3)
    got, ref = _both(jm, tm, _ids(), 12, **kw)
    assert got.shape == (2, 19)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_beam_search_with_frozen_eos_beams_matches_reference(int8):
    """EOS is the greedy first token of prompt 0: its beams freeze at once
    and carry EOS to the end at an unchanged score."""
    jm, tm = pair(seed=3)
    ids = _ids()
    eos = int(generate(tm, ids, 1, int8=int8)[0, -1])
    got, ref = _both(jm, tm, ids, 12, beam_size=4, eos_token_id=eos,
                     length_penalty=1.0, int8=int8)
    np.testing.assert_array_equal(got, ref)
    assert (got[0, 7:] == eos).any()


def test_beam_size_one_is_greedy_decoding():
    _, tm = pair(seed=3)
    ids = _ids(seed=1, b=3, t=5)
    np.testing.assert_array_equal(
        build_beam_search_fn(tm, 10, beam_size=1)(ids).numpy(),
        generate(tm, ids, 10).numpy())


def test_beam_search_single_new_token_and_length_check():
    """One new token is the top-1 of the prompt's last position (no
    decode step at all); a prompt that would pass max_seq_len raises."""
    jm, tm = pair(seed=3)
    got, ref = _both(jm, tm, _ids(), 1, beam_size=4)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, generate(tm, _ids(), 1).numpy())
    with pytest.raises(ValueError, match="max_seq_len"):
        build_beam_search_fn(tm, 90)(_ids())
