"""Beam search (``nn.decode``: ``BeamSearchDecoder`` over a cell, driven
by ``dynamic_decode``) against the JAX package, on the CPU, with the same
seeded weights: an LSTM decoder, a cell whose every candidate ties (the
top-k must keep the lower flat index of ``beam * vocab``, as
``jax.lax.top_k`` does), and a decoder whose beams all finish early
(finished beams extend only with the end token; the loop stops once all
have finished).

The reference's step runs under ``jax.jit`` (one program for all its
steps; its eager operations would compile one by one). Tolerance: the
sequences must be equal; the final log-probabilities float32 rtol 1e-5 /
atol 1e-5 (log-softmax sums in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.nn as jnn
import paddle_tpu_torch.nn as tnn
from paddle_tpu.nn import initializer as JI

LP = dict(rtol=1e-5, atol=1e-5)
VOCAB, EMB, HIDDEN = 12, 6, 8


class _NumpyZeros(JI.Initializer):
    def __call__(self, key, shape, dtype):
        return jnp.asarray(np.zeros(shape, np.float32))


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.fixture(scope="module")
def lstm_pair():
    """The reference's and the port's LSTM cell, embedding and output
    projection, carrying the same seeded weights."""
    JI.set_global_initializer(_NumpyZeros(), _NumpyZeros())
    try:
        jcell = jnn.LSTMCell(EMB, HIDDEN)
    finally:
        JI.set_global_initializer(None, None)
    tcell = tnn.LSTMCell(EMB, HIDDEN, device="cpu")
    state = {k: _rand(tuple(v.shape), i) for i, (k, v) in
             enumerate(sorted(jcell.state_dict().items()))}
    jcell.set_state_dict({k: jnp.asarray(v) for k, v in state.items()})
    tcell.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    emb, out_w = _rand((VOCAB, EMB), 10), _rand((HIDDEN, VOCAB), 11) * 2
    ref = jnn.BeamSearchDecoder(
        jcell, start_token=0, end_token=1, beam_size=4,
        embedding_fn=lambda ids: jnp.asarray(emb)[ids],
        output_fn=lambda h: h @ jnp.asarray(out_w))
    te, tw = torch.from_numpy(emb), torch.from_numpy(out_w)
    port = tnn.BeamSearchDecoder(
        tcell, start_token=0, end_token=1, beam_size=4,
        embedding_fn=lambda ids: te[ids], output_fn=lambda h: h @ tw)
    return ref, port


def _decode_both(ref, port, inits_np, max_step_num, batch_size=None):
    jinits = None if inits_np is None else tuple(
        jnp.asarray(a) for a in inits_np)
    tinits = None if inits_np is None else tuple(
        torch.from_numpy(a) for a in inits_np)
    step = ref.step
    ref.step = jax.jit(step)
    try:
        jseq, jlp = jnn.dynamic_decode(ref, jinits, max_step_num=max_step_num,
                                       batch_size=batch_size)
    finally:
        ref.step = step
    tseq, tlp = tnn.dynamic_decode(port, tinits, max_step_num=max_step_num,
                                   batch_size=batch_size)
    np.testing.assert_array_equal(tseq.numpy(), np.asarray(jseq))
    np.testing.assert_allclose(tlp.detach().numpy(), np.asarray(jlp), **LP)
    return tseq, tlp


def test_lstm_beam_search_matches_the_reference(lstm_pair):
    ref, port = lstm_pair
    h0, c0 = _rand((3, HIDDEN), 12), _rand((3, HIDDEN), 13)
    seq, lp = _decode_both(ref, port, (h0, c0), max_step_num=9)
    assert seq.shape[:2] == (3, 4) and seq.dtype == torch.int64
    # beams come out best first
    assert bool((lp[:, :-1] >= lp[:, 1:]).all())


def test_ties_break_toward_the_lower_flat_index():
    """Every candidate scores alike: the kept beams are the lowest flat
    indices (tokens 0-3 of beam 0 first), and end_token 2 among them
    finishes that beam, which then ranks first (it extends at no cost)
    while the others pay log(7) a step."""
    def cell(inp, states):
        return inp, states

    ref = jnn.BeamSearchDecoder(
        cell, 0, 2, 4, embedding_fn=lambda ids: jnp.zeros((ids.shape[0], 7)),
        output_fn=lambda h: jnp.zeros((h.shape[0], 7)))
    port = tnn.BeamSearchDecoder(
        cell, 0, 2, 4, embedding_fn=lambda ids: torch.zeros(ids.shape[0], 7),
        output_fn=lambda h: torch.zeros(h.shape[0], 7))
    state = np.zeros((2, 3), np.float32)
    seq, _ = _decode_both(ref, port, (state,), max_step_num=5)
    assert seq[0, 0].tolist() == [2] * seq.shape[-1]
    assert seq[0, :, 0].tolist() == [2, 0, 0, 0]


def test_all_beams_finishing_stops_the_loop(lstm_pair):
    """An output layer that favours the end token: every beam ends in
    the first steps, the loop stops there, and finished beams keep only
    the end token. No initial states: the cell starts from zeros."""
    ref, port = lstm_pair
    bias = np.zeros(VOCAB, np.float32)
    bias[1] = 40.0
    jout, tout = ref.output_fn, port.output_fn
    ref.output_fn = lambda h: jout(h) + jnp.asarray(bias)
    port.output_fn = lambda h: tout(h) + torch.from_numpy(bias)
    try:
        seq, _ = _decode_both(ref, port, None, max_step_num=20, batch_size=2)
    finally:
        ref.output_fn, port.output_fn = jout, tout
    assert seq.shape[-1] < 20
    assert bool((seq[..., -1] == 1).all())
