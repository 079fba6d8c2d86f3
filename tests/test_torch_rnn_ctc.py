"""The port's recurrent layers (``paddle_tpu_torch.nn.layers.rnn``) and
CTC loss (``F.ctc_loss``, ``CTCLoss``) against the JAX package's, on the
CPU, from numpy inputs made from seeds and the port's seeded weights
copied into the reference by name.

Recurrent layers: every cell, layer class and direction, batch- and
time-major, one and two layers, with and without initial states; the
outputs, the final states (their nesting too: per layer stacked, and
``(state_fw, state_bw)`` for two directions), the gradients, the
parameter names, dropout between layers only, ``sequence_length``
ignored. float32 tolerance rtol 1e-5 / atol 1e-6 (a time loop of
float32 products against a ``lax.scan``).

CTC: values and logit gradients for each reduction and
``norm_by_times``, repeated labels (no skip between equal labels),
another blank, an infeasible label (the reference's finite value, about
1e30, where ``torch.nn.functional.ctc_loss`` gives ``inf``) and frames
past a sequence's end (zero gradient). rtol 1e-5 / atol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn import functional as JF
from paddle_tpu.nn import initializer as JI
from paddle_tpu.nn.layers import loss as JL
from paddle_tpu.nn.layers import rnn as JR
from paddle_tpu.nn.layer import functional_call, param_state
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layers import loss as TL
from paddle_tpu_torch.nn.layers import rnn as TR
from torch_threads import few_torch_threads  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-6)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _twin(tm, jcls, *args, **kw):
    """The reference layer ``jcls(*args, **kw)`` carrying ``tm``'s
    parameters (built under a zero initializer, then given them)."""
    JI.set_global_initializer(JI.Constant(0.0), JI.Constant(0.0))
    try:
        jm = jcls(*args, **kw)
    finally:
        JI.set_global_initializer(None, None)
    state = {k: jnp.asarray(v.detach().numpy().copy())
             for k, v in tm.state_dict().items()}
    assert sorted(state) == sorted(jm.state_dict())
    missing, unexpected = jm.set_state_dict(state)
    assert not missing and not unexpected
    return jm


def _flatten(tree):
    if isinstance(tree, (tuple, list)):
        return [type(tree).__name__] + [x for t in tree for x in _flatten(t)]
    return [tree]


def _assert_tree_close(got, want):
    fg, fw = _flatten(got), _flatten(want)
    assert [type(x).__name__ if isinstance(x, str) else "leaf" for x in fg] \
        == [type(x).__name__ if isinstance(x, str) else "leaf" for x in fw]
    for a, b in zip(fg, fw):
        if isinstance(a, str):
            assert a == b
        else:
            np.testing.assert_allclose(_np(a), _np(b), **TOL)


CELLS = [("SimpleRNNCell", {}), ("SimpleRNNCell", {"activation": "relu"}),
         ("LSTMCell", {}), ("GRUCell", {})]


@pytest.mark.parametrize("name,kw", CELLS)
def test_cells_forward_and_gradients(name, kw):
    tm = getattr(TR, name)(5, 7, device="cpu", generator=_gen(1), **kw)
    jm = _twin(tm, getattr(JR, name), 5, 7, **kw)
    x = _rand((3, 5), 2)
    h = _rand((3, 7), 3)
    states = (h, _rand((3, 7), 4)) if name == "LSTMCell" else h
    for st in (None, states):
        tst = None if st is None else (
            tuple(torch.from_numpy(s) for s in st)
            if isinstance(st, tuple) else torch.from_numpy(st))
        jst = None if st is None else (
            tuple(jnp.asarray(s) for s in st) if isinstance(st, tuple)
            else jnp.asarray(st))
        _assert_tree_close(tm(torch.from_numpy(x), tst), jm(jnp.asarray(x),
                                                            jst))

    def jloss(p, a):
        (out, _), _ = functional_call(jm, p, {}, a, jst)
        return jnp.sum(out * out)

    gj = jax.grad(lambda p: jloss(p, jnp.asarray(x)))(param_state(jm))
    tx = torch.from_numpy(x).requires_grad_()
    out, _ = tm(tx, tst)
    (out * out).sum().backward()
    for k, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), _np(gj[k]), err_msg=k,
                                   **TOL)


@pytest.mark.parametrize("name", ["SimpleRNN", "LSTM", "GRU"])
@pytest.mark.parametrize("direction", ["forward", "bidirect"])
@pytest.mark.parametrize("time_major", [False, True])
def test_layers_outputs_states_and_names(name, direction, time_major):
    tm = getattr(TR, name)(6, 5, num_layers=2, direction=direction,
                           time_major=time_major, device="cpu",
                           generator=_gen(5))
    jm = _twin(tm, getattr(JR, name), 6, 5, num_layers=2,
               direction=direction, time_major=time_major)
    tm.eval()
    jm.eval()
    x = _rand((4, 3, 6) if time_major else (3, 4, 6), 6)
    got = tm(torch.from_numpy(x))
    want = jm(jnp.asarray(x))
    _assert_tree_close(got, want)
    # given initial states (the final ones, in the same nesting), and a
    # sequence_length that is accepted and not read
    st_t = got[1]
    st_j = want[1]
    _assert_tree_close(tm(torch.from_numpy(x), st_t,
                          sequence_length=torch.tensor([1, 2, 3])),
                       jm(jnp.asarray(x), st_j))


@pytest.mark.parametrize("name", ["LSTM", "GRU", "SimpleRNN"])
def test_layer_gradients(name):
    tm = getattr(TR, name)(4, 6, num_layers=2, direction="bidirect",
                           device="cpu", generator=_gen(7))
    jm = _twin(tm, getattr(JR, name), 4, 6, num_layers=2,
               direction="bidirect")
    x = _rand((2, 5, 4), 8)
    w = _rand((2, 5, 12), 9)

    def jloss(p, a):
        (out, _), _ = functional_call(jm, p, {}, a)
        return jnp.sum(out * w)

    gj, gxj = jax.grad(jloss, argnums=(0, 1))(param_state(jm),
                                              jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    out, _ = tm(tx)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), _np(gxj), **TOL)
    for k, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), _np(gj[k]), err_msg=k,
                                   **TOL)


def test_rnn_and_birnn_wrappers_and_reverse():
    cell = TR.GRUCell(3, 4, device="cpu", generator=_gen(10))
    jcell = _twin(cell, JR.GRUCell, 3, 4)
    x = _rand((2, 6, 3), 11)
    for rev in (False, True):
        _assert_tree_close(TR.RNN(cell, is_reverse=rev)(torch.from_numpy(x)),
                           JR.RNN(jcell, is_reverse=rev)(jnp.asarray(x)))
    bw = TR.GRUCell(3, 4, device="cpu", generator=_gen(12))
    jbw = _twin(bw, JR.GRUCell, 3, 4)
    _assert_tree_close(TR.BiRNN(cell, bw)(torch.from_numpy(x)),
                       JR.BiRNN(jcell, jbw)(jnp.asarray(x)))


def test_dropout_between_layers_only_in_training():
    x = torch.from_numpy(_rand((2, 5, 4), 13))
    one = TR.LSTM(4, 6, dropout=0.5, device="cpu", generator=_gen(14))
    torch.testing.assert_close(one.train()(x)[0], one.eval()(x)[0])
    two = TR.LSTM(4, 6, num_layers=2, dropout=0.5, device="cpu",
                  generator=_gen(14))
    jm = _twin(two, JR.LSTM, 4, 6, num_layers=2, dropout=0.5)
    jm.eval()
    _assert_tree_close(two.eval()(x), jm(jnp.asarray(x.numpy())))
    trained, _ = two.train()(x)
    assert not torch.allclose(trained, two.eval()(x)[0])


def _ctc_inputs(seed, T=12, B=4, C=6, S=4):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(T, B, C)).astype(np.float32) * 2
    lab_len = np.asarray([4, 1, 3, 2][:B], np.int32)
    in_len = np.asarray([12, 7, 10, 5][:B], np.int32)
    labels = rng.integers(1, C, (B, S)).astype(np.int32)
    labels[2, :3] = [2, 2, 3]              # a repeat: no skip between them
    return logits, labels, in_len, lab_len


def _ctc_both(logits, labels, in_len, lab_len, **kw):
    def jl(lg):
        out = JF.ctc_loss(lg, labels, in_len, lab_len, **kw)
        return out.sum(), out

    (_, lj), gj = jax.value_and_grad(jl, has_aux=True)(jnp.asarray(logits))
    tl = torch.from_numpy(logits).requires_grad_()
    lt = F.ctc_loss(tl, torch.from_numpy(labels), torch.from_numpy(in_len),
                    torch.from_numpy(lab_len), **kw)
    lt.sum().backward()
    return lt.detach().numpy(), _np(lj), tl.grad.numpy(), _np(gj)


@pytest.mark.parametrize("reduction", ["none", "sum", "mean"])
@pytest.mark.parametrize("norm_by_times", [False, True])
def test_ctc_loss_values_and_gradients(reduction, norm_by_times):
    args = _ctc_inputs(20)
    lt, lj, gt, gj = _ctc_both(*args, reduction=reduction,
                               norm_by_times=norm_by_times)
    np.testing.assert_allclose(lt, lj, **TOL)
    np.testing.assert_allclose(gt, gj, **TOL)
    assert (gt[5:, 3] == 0).all()           # past sequence 3's 5 frames


def test_ctc_loss_matches_torch_on_feasible_labels_and_other_blank():
    logits, labels, in_len, lab_len = _ctc_inputs(21)
    ref = torch.nn.functional.ctc_loss(
        torch.log_softmax(torch.from_numpy(logits), -1),
        torch.from_numpy(labels).long(), torch.from_numpy(in_len).long(),
        torch.from_numpy(lab_len).long(), reduction="none")
    got = F.ctc_loss(torch.from_numpy(logits), labels, in_len, lab_len,
                     reduction="none")
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    labels0 = np.where(labels == 5, 0, labels)   # blank 5: ids 0..4
    lt, lj, gt, gj = _ctc_both(logits, labels0, in_len, lab_len, blank=5)
    np.testing.assert_allclose(lt, lj, **TOL)
    np.testing.assert_allclose(gt, gj, **TOL)


def test_ctc_loss_infeasible_label_is_the_references_finite_value():
    logits, labels, in_len, lab_len = _ctc_inputs(22)
    in_len = np.asarray([3, 7, 10, 5], np.int32)  # 4 labels in 3 frames
    lt, lj, gt, gj = _ctc_both(logits, labels, in_len, lab_len,
                               reduction="none")
    assert np.isfinite(lt).all() and lt[0] > 1e29
    np.testing.assert_allclose(lt, lj, rtol=1e-6)
    assert np.isfinite(gt).all()
    np.testing.assert_allclose(gt, gj, **TOL)
    lib = torch.nn.functional.ctc_loss(
        torch.log_softmax(torch.from_numpy(logits), -1),
        torch.from_numpy(labels).long(), torch.from_numpy(in_len).long(),
        torch.from_numpy(lab_len).long(), reduction="none",
        zero_infinity=False)
    assert torch.isinf(lib[0])


def test_ctc_loss_layer():
    logits, labels, in_len, lab_len = _ctc_inputs(23)
    for reduction in ("sum", "mean"):
        got = TL.CTCLoss(reduction=reduction)(
            torch.from_numpy(logits), labels, in_len, lab_len,
            norm_by_times=True)
        want = JL.CTCLoss(reduction=reduction)(
            jnp.asarray(logits), labels, in_len, lab_len, norm_by_times=True)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    assert "CTCLoss" in TL.__all__
