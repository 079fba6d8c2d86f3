"""dy2static: AST conversion of Python control flow for capture (port of
``paddle_tpu/jit/dy2static.py``).

Reference parity: ``python/paddle/fluid/dygraph/dygraph_to_static/`` — the
``ProgramTranslator`` AST transformer set (``program_translator.py``,
``ifelse_transformer.py``, ``loop_transformer.py``) that converts
tensor-dependent ``if``/``while``/``for`` into ``cond``/``while_loop`` ops.

The AST side (the transformer, the escape and return lowering, the
entry point) is the JAX package's, copied. Each ``if`` / ``while`` / ``for``
statement is rewritten into a functional form whose assigned locals are
threaded explicitly, dispatched at RUNTIME by the helpers below, which
are written for torch:

- the condition is concrete (a Python value, or a tensor in eager mode)
  -> plain Python control flow. Eager torch evaluates a tensor predicate
  itself, so converted code run eagerly gives exactly what the
  unconverted function gives;
- the condition is being captured (a tensor under ``torch.export`` or
  ``torch.compile``: ``torch.compiler.is_exporting()`` /
  ``is_compiling()``, or a fake tensor) -> ``torch.cond`` for ``if``,
  torch's higher-order ``while_loop`` for an unbounded ``while`` and a
  ``for`` over a range with tensor bounds, and, with
  ``to_static(fn, loop_bound=N)``, a masked loop of N trips for
  ``while`` that autograd differentiates (the reference's masked
  ``lax.scan``, the ``while_grad`` analogue).

Under capture, only tensors (and Python numbers, made tensors on the
predicate's device) ride the operands and carries of ``torch.cond`` and
``while_loop``; other values, ``UNDEF`` included, stay bound by closure,
as the reference splits them out of its lax carries. A ``for`` over a
tensor unrolls under capture, as the unconverted loop would.

The limits are the reference's (``return`` inside loops/try and escapes
buried in ``try``/``with``/``match`` keep their block un-converted; a
converted ``for`` loop's target read after the loop sees its pre-loop
value; foreign decorators, generators, ``super()`` and a walrus in a
``while`` test skip conversion), and one of torch's: ``while_loop`` is
forward-only, so a captured ``while`` that must be differentiated needs
``loop_bound``.
"""
from __future__ import annotations

import ast
import functools
import inspect
import itertools
import logging
import sys
import textwrap
import types
from dataclasses import dataclass
from typing import Any, Callable, Sequence

import torch

__all__ = ["convert_control_flow", "convert_if", "convert_while",
           "convert_for", "make_range", "maybe", "UNDEF"]

_log = logging.getLogger(__name__)

# >0: log the rebuilt source of every converted function (set via
# paddle_tpu_torch.jit.set_code_level — the reference's transformed-code
# dump)
CODE_LEVEL = 0


# --------------------------------------------------------------- runtime
class _Undef:
    """Placeholder for 'variable not yet defined here' (the reference's
    ``UndefinedVar``). Any use poisons loudly instead of mis-executing."""

    _MSG = ("variable is not defined on every path through converted "
            "control flow (dy2static): define it before the if/loop, or "
            "in both branches")

    def __repr__(self):
        return "<dy2static UNDEF>"

    def _poison(self, *a, **k):
        raise RuntimeError(self._MSG)

    __bool__ = __call__ = __getattr__ = __getitem__ = _poison
    __add__ = __radd__ = __mul__ = __rmul__ = __sub__ = _poison
    __iter__ = __len__ = __float__ = __int__ = _poison


UNDEF = _Undef()


def maybe(thunk: Callable[[], Any]):
    """Evaluate a variable read, mapping not-yet-defined to UNDEF."""
    try:
        return thunk()
    except (NameError, UnboundLocalError):
        return UNDEF


def _capturing() -> bool:
    return torch.compiler.is_exporting() or torch.compiler.is_compiling()


def _is_traced(x) -> bool:
    """A tensor whose value is not known: one met while torch captures a
    program, or a fake tensor."""
    if not isinstance(x, torch.Tensor):
        return False
    from torch._subclasses.fake_tensor import is_fake

    return _capturing() or is_fake(x)


def _as_pred(x):
    t = torch.as_tensor(x)
    if t.ndim != 0:
        raise ValueError(
            f"converted condition must be a scalar, got shape "
            f"{tuple(t.shape)}")
    return t.to(torch.bool)


def logical_not(x):
    """``not x`` that stays capturable: python ``not`` for concrete values
    (exact truthiness semantics, eager tensors included),
    ``torch.logical_not`` for captured tensors."""
    if _is_traced(x):
        return torch.logical_not(x)
    return not x


def logical_and(a, b_thunk):
    """Short-circuit-preserving AND for synthesized loop tests: ``b`` is a
    thunk so the concrete path skips it when ``a`` is falsy — after a
    lowered ``break`` fires, the original loop test must NOT be
    re-evaluated (python's ``break`` exits without re-testing, and the
    test may only be well-defined pre-break). A captured ``a`` evaluates
    both and ands them (the captured loop needs the value either way)."""
    if _is_traced(a):
        return torch.logical_and(a, torch.as_tensor(b_thunk(),
                                                    device=a.device))
    return a and b_thunk()


def range_cond(i, stop, step):
    """Loop-continuation test of a ``for _ in range(...)`` rewritten as a
    while (break/continue lowering): direction-aware, capturable."""
    # a CONCRETE zero step must raise like python's range() even when the
    # bounds are captured
    if not _is_traced(step) and step == 0:
        raise ValueError("range() arg 3 must not be zero")
    if _is_traced(step) or _is_traced(i) or _is_traced(stop):
        step = torch.as_tensor(step)
        return torch.where(step > 0, torch.as_tensor(i < stop),
                           torch.as_tensor(i > stop))
    return i < stop if step > 0 else i > stop


def range_trip_bound(start, stop, step, default_bound):
    """Natural iteration bound of a ``for-range`` lowered to a while: a
    ``break`` can only SHORTEN the loop, so with concrete bounds the
    range's own trip count is the exact bound — a user ``loop_bound``
    sized for unbounded whiles must not truncate a statically-counted
    for. Calling the builtin also restores python's argument validation
    (``range(2.5)`` raises TypeError). Captured bounds fall back to
    ``default_bound``."""
    if not _is_traced(step) and step == 0:
        raise ValueError("range() arg 3 must not be zero")
    if any(_is_traced(v) for v in (start, stop, step)):
        return default_bound
    return len(range(start, stop, step))


def _split_state(init: tuple, like):
    """Split a carry for ``torch.cond`` / ``while_loop``: tensors ride the
    operands, Python numbers too (as tensors on ``like``'s device); every
    other value (UNDEF, objects) stays closure-bound — correct for
    body-local temporaries that are reassigned before being read each
    iteration, and a read-before-assign still poisons loudly.

    Returns ``(defined_indices, values, fill)`` where ``fill(dvals)``
    rebuilds the full positional tuple."""
    defined, values = [], []
    for i, v in enumerate(init):
        if isinstance(v, torch.Tensor):
            defined.append(i)
            values.append(v)
        elif isinstance(v, (bool, int, float)):
            defined.append(i)
            values.append(torch.as_tensor(v, device=like.device))

    def fill(dvals):
        full = list(init)
        for i, v in zip(defined, dvals):
            full[i] = v
        return full

    return defined, tuple(values), fill


def _tensor_outputs(out, defined, inputs, like):
    """The carried slots of a branch or body result as fresh tensors (the
    higher-order ops take tensors and refuse an output that aliases an
    input)."""
    res = []
    for i in defined:
        v = out[i]
        if not isinstance(v, torch.Tensor):
            v = torch.as_tensor(v, device=like.device)
        elif any(v is x for x in inputs):
            v = v.clone()
        res.append(v)
    return tuple(res)


def convert_if(pred, true_fn, false_fn, operands: tuple):
    """``if`` dispatch. ``true_fn``/``false_fn`` take the carried locals
    positionally and return their updated tuple."""
    if not _is_traced(pred):
        return true_fn(*operands) if pred else false_fn(*operands)
    # the defined slots ride the operands; every slot comes out of both
    # branches (a name first bound inside them included)
    _, values, fill = _split_state(operands, pred)

    def branch(fn):
        def run(*dops):
            out = fn(*fill(dops))
            return _tensor_outputs(out, range(len(out)), dops, pred)
        return run

    return tuple(torch.cond(_as_pred(pred), branch(true_fn),
                            branch(false_fn), values))


def _bounded_while(test_fn, body_fn, init: tuple, bound: int, like):
    """Masked loop of ``bound`` trips with while semantics (autograd
    differentiates it; the reference's masked ``lax.scan``).

    Two selects per step ("double where"): the body also RUNS on the
    frozen post-exit state for the masked tail steps, where it may be
    numerically undefined (1/x at a converged root, sqrt of a crossed
    threshold); masking only the OUTPUT would still backprop 0 * NaN
    through the dead branch. Feeding the body the initial state whenever
    the step is dead keeps the dead branch finite (the body was
    evaluated on init by the first real step), so its zero cotangent
    stays zero.
    """
    defined, init_t, fill = _split_state(tuple(init), like)
    state = init_t
    for _ in range(bound):
        alive = _as_pred(test_fn(*fill(state)))
        safe = tuple(torch.where(alive, s, i) for s, i in zip(state, init_t))
        new = _tensor_outputs(body_fn(*fill(safe)), defined, (), like)
        state = tuple(torch.where(alive, n, o) for n, o in zip(new, state))
    return tuple(fill(state))


def convert_while(test_fn, body_fn, init: tuple, bound=None):
    """``while`` dispatch: python loop when the condition is concrete
    (eager tensors included); torch's ``while_loop`` when it is captured;
    a bounded masked loop (differentiable) when the conversion was built
    with ``to_static(..., loop_bound=N)``.

    The bound is BAKED into the converted function — deliberately not
    ambient state, as in the reference.
    """
    carry = tuple(init)
    first = test_fn(*carry)
    # run while the condition stays concrete; the condition can BECOME
    # captured mid-loop (e.g. a lowered break flag fed by a tensor
    # comparison) — hand the current carry to the captured path then
    while not _is_traced(first) and first:
        carry = tuple(body_fn(*carry))
        first = test_fn(*carry)
    if not _is_traced(first):
        return carry
    if bound is not None:
        return _bounded_while(test_fn, body_fn, carry, int(bound), first)
    defined, values, fill = _split_state(carry, first)
    out = _while_loop(
        lambda *c: _as_pred(test_fn(*fill(c))),
        lambda *c: _tensor_outputs(body_fn(*fill(c)), defined, c, first),
        values)
    return tuple(fill(out))


def _while_loop(cond_fn, body_fn, carried: tuple):
    from torch._higher_order_ops.while_loop import while_loop

    return while_loop(cond_fn, body_fn, tuple(carried))


@dataclass(frozen=True)
class _RangeSpec:
    """A ``range(...)`` whose bounds are captured tensors (a plain range()
    would read their values, which capture does not know)."""

    start: Any
    stop: Any
    step: Any


def make_range(*args):
    if not any(_is_traced(a) for a in args):
        return range(*args)
    if len(args) == 1:
        return _RangeSpec(0, args[0], 1)
    if len(args) == 2:
        return _RangeSpec(args[0], args[1], 1)
    return _RangeSpec(*args)


def can_index(seq) -> bool:
    """Can ``for x in seq`` be replaced by ``for i in range(len(seq)):
    x = seq[i]``? Conservative allowlist: LENGTH-IMMUTABLE positional
    sequences and arrays, where iteration is exactly indexing. Lists are
    deliberately excluded — python's list iterator tracks append/pop
    during the loop, which a len-snapshot rewrite would silently miss —
    as are generators, dicts (iterate keys), strings, and custom
    iterables: they all keep the exact python loop."""
    if isinstance(seq, (tuple, range)):
        return True
    import numpy as _np

    if isinstance(seq, (_np.ndarray, torch.Tensor)):
        return seq.ndim > 0
    return False


def seq_len(seq) -> int:
    return len(seq)


def convert_for(iterable, body_fn, init: tuple):
    """``for`` dispatch. ``body_fn(loop_var, *carry) -> carry``."""
    if isinstance(iterable, _RangeSpec):
        like = next(a for a in (iterable.start, iterable.stop, iterable.step)
                    if isinstance(a, torch.Tensor))
        start, stop, step = (torch.as_tensor(a, device=like.device)
                             for a in (iterable.start, iterable.stop,
                                       iterable.step))
        # iteration count, correct for negative steps, clamped at 0
        n = torch.clamp(torch.div(stop - start + step - torch.sign(step),
                                  step, rounding_mode="floor"), min=0)
        defined, values, fill = _split_state(tuple(init), like)
        k0 = torch.zeros((), dtype=n.dtype, device=like.device)

        def body(k, *c):
            out = body_fn(start + k * step, *fill(c))
            return (k + 1, *_tensor_outputs(out, defined, c, like))

        out = _while_loop(lambda k, *c: k < n, body, (k0, *values))
        return tuple(fill(out[1:]))
    carry = tuple(init)
    for x in iterable:
        carry = tuple(body_fn(x, *carry))
    return carry


# ----------------------------------------------------------- AST analysis
_SCOPE_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda,
                ast.ClassDef, ast.ListComp, ast.SetComp, ast.DictComp,
                ast.GeneratorExp)


def _assigned_names(nodes) -> set:
    """Names bound in ``nodes``: Store/Del contexts, plus def/class names
    and import aliases (they bind in the enclosing scope too). Does not
    descend into nested scopes (their internal bindings are their own)."""
    out: set = set()

    def walk(node):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)  # the NAME binds here; the body is its own
            return
        if isinstance(node, _SCOPE_NODES):
            return
        if isinstance(node, ast.Name) and isinstance(
                node.ctx, (ast.Store, ast.Del)):
            out.add(node.id)
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            for alias in node.names:
                out.add(alias.asname or alias.name.split(".")[0])
        for child in ast.iter_child_nodes(node):
            walk(child)

    for n in nodes:
        walk(n)
    # our own synthesized helpers re-bind on every execution of the block;
    # threading them as loop/branch state would put non-tensor callables
    # (or UNDEF on the first iteration) into torch.cond / while_loop carries
    return {n for n in out if not n.startswith("_d2s_")}


def _unconvertible(nodes, *, loops_shield: bool) -> bool:
    """True if ``nodes`` contain a construct that cannot be moved into an
    extracted function without changing semantics: return; break/continue
    binding to an OUTER loop (``loops_shield``: ones inside a nested loop
    bind there and are fine); global/nonlocal declarations (a parameter
    would shadow the outer binding); ``except ... as e`` (python unbinds
    the name after the handler, so threading it out would crash)."""
    found = False

    def walk(node, in_loop):
        nonlocal found
        if found or isinstance(node, _SCOPE_NODES):
            return
        if isinstance(node, (ast.Return, ast.Global, ast.Nonlocal)):
            found = True
            return
        if isinstance(node, ast.ExceptHandler) and node.name:
            found = True
            return
        if isinstance(node, (ast.Break, ast.Continue)) and not in_loop:
            found = True
            return
        if isinstance(node, (ast.For, ast.AsyncFor, ast.While)):
            # the loop's BODY shields its own escapes, but an escape in
            # its else clause binds to the loop ENCLOSING this one
            for child in node.body:
                walk(child, in_loop or loops_shield)
            for child in node.orelse:
                walk(child, in_loop)
            return
        for child in ast.iter_child_nodes(node):
            walk(child, in_loop)

    for n in nodes:
        walk(n, False)
    return found


def _contains(nodes, types_) -> bool:
    for n in nodes:
        for sub in ast.walk(n):
            if isinstance(sub, types_):
                return True
    return False


def _name(id_, ctx=None):
    return ast.Name(id=id_, ctx=ctx or ast.Load())


def _maybe_call(var: str) -> ast.expr:
    # _jst.maybe(lambda: var)
    return ast.Call(
        func=ast.Attribute(value=_name("_jst"), attr="maybe",
                           ctx=ast.Load()),
        args=[ast.Lambda(
            args=ast.arguments(posonlyargs=[], args=[], kwonlyargs=[],
                               kw_defaults=[], defaults=[]),
            body=_name(var))],
        keywords=[])


def _tuple_of(names, ctx=None):
    return ast.Tuple(elts=[_name(n, ctx and type(ctx)()) for n in names],
                     ctx=ctx or ast.Load())


def _fn_def(name: str, params: Sequence[str], body, returns: Sequence[str]):
    # returns are maybe-wrapped: a carried name may have been del'd (or
    # conditionally bound) inside the block; it comes back as UNDEF rather
    # than crashing the synthesized return
    ret = ast.Tuple(elts=[_maybe_call(r) for r in returns], ctx=ast.Load())
    return ast.FunctionDef(
        name=name,
        args=ast.arguments(
            posonlyargs=[], kwonlyargs=[], kw_defaults=[], defaults=[],
            args=[ast.arg(arg=p) for p in params]),
        body=list(body) + [ast.Return(value=ret)],
        decorator_list=[])


def _jst_call(helper: str, args) -> ast.Call:
    return ast.Call(
        func=ast.Attribute(value=_name("_jst"), attr=helper,
                           ctx=ast.Load()),
        args=list(args), keywords=[])


def _result_stmt(carried, call: ast.Call) -> ast.stmt:
    if carried:
        return ast.Assign(targets=[_tuple_of(carried, ast.Store())],
                          value=call)
    return ast.Expr(value=call)


# ------------------------------------------------------ return lowering
# The result-variable name deliberately does NOT use the "_d2s_" prefix:
# _assigned_names drops that prefix from carried state, and the return
# value must be threaded OUT of the extracted branch functions.
_RET_VAR = "__return_value__"


def _fn_level_return(nodes) -> bool:
    """Any ``return`` reachable at function level (not inside a nested
    scope, loop, or try)."""
    stop = _SCOPE_NODES + (ast.For, ast.AsyncFor, ast.While, ast.Try)
    found = False

    def walk(node):
        nonlocal found
        if found or isinstance(node, stop):
            return
        if isinstance(node, ast.Return):
            found = True
            return
        for child in ast.iter_child_nodes(node):
            walk(child)

    for n in nodes:
        walk(n)
    return found


def _hazardous_return(fdef) -> bool:
    """A ``return`` inside a loop or try (at function level) cannot be
    lowered by branch folding — leave the whole function's returns alone
    (those constructs stay trace-only, as documented)."""
    hazard = (ast.For, ast.AsyncFor, ast.While, ast.Try)
    found = False

    def walk(node, in_hazard):
        nonlocal found
        if found or isinstance(node, _SCOPE_NODES):
            return
        if isinstance(node, ast.Return) and in_hazard:
            found = True
            return
        nested = in_hazard or isinstance(node, hazard)
        for child in ast.iter_child_nodes(node):
            walk(child, nested)

    walk(fdef, False)
    return found


def _fold_returns(body):
    """Restructure a statement list so every ``return`` ends a (possibly
    nested) trailing if-chain: statements after a return-containing If
    are folded into its branches (dead code after a return is dropped).
    The caller appends an explicit ``return None`` sentinel first, so
    every path ends in a Return."""
    import copy

    out = []
    for i, st in enumerate(body):
        if isinstance(st, ast.Return):
            out.append(st)
            return out  # anything after is unreachable
        if isinstance(st, ast.If) and _fn_level_return([st]):
            rest = body[i + 1:]
            st.body = _fold_returns(list(st.body) + copy.deepcopy(rest))
            st.orelse = _fold_returns(list(st.orelse) + rest)
            out.append(st)
            return out
        out.append(st)
    return out


def _retify_tail(body):
    """After folding, rewrite each trailing ``return expr`` into
    ``__return_value__ = expr`` so the if-chain becomes convertible."""
    last = body[-1]
    if isinstance(last, ast.Return):
        body[-1] = ast.Assign(
            targets=[_name(_RET_VAR, ast.Store())],
            value=last.value or ast.Constant(value=None))
    else:  # by construction the tail is an If whose branches both return
        _retify_tail(last.body)
        _retify_tail(last.orelse)
    return body


def _lower_returns(fdef):
    """Make mid-function returns convertible (the reference's
    ReturnTransformer, ``python/paddle/jit/dy2static/return_transformer
    .py``): ``if cond: return a`` / ``return b`` becomes an if/else
    assigning one result variable, so a tensor ``cond`` lowers to
    ``torch.cond`` under capture instead of degrading the whole If to trace-only.
    Returns inside loops/try are left untouched (still trace-only)."""
    if not any(isinstance(st, ast.If) and _fn_level_return([st])
               for st in fdef.body):
        return fdef
    if _hazardous_return(fdef):
        return fdef
    folded = _fold_returns(
        list(fdef.body) + [ast.Return(value=ast.Constant(value=None))])
    fdef.body = _retify_tail(folded) + [
        ast.Return(value=_name(_RET_VAR))]
    return fdef


# -------------------------------------------- break/continue lowering
def _own_escapes(body) -> bool:
    """True if ``body`` contains a break/continue BELONGING TO THIS LOOP
    (nested loops shield theirs; nested scopes are opaque) — the trigger
    for escape lowering. A nested loop's break must not trigger a
    rewrite of the outer loop."""
    found = False

    def walk(node, shielded):
        nonlocal found
        if found or isinstance(node, _SCOPE_NODES):
            return
        if isinstance(node, (ast.Break, ast.Continue)) and not shielded:
            found = True
            return
        if isinstance(node, (ast.For, ast.AsyncFor, ast.While)):
            # the nested loop's BODY shields its escapes; escapes in its
            # else clause bind to THIS loop and must be seen
            for child in node.body:
                walk(child, True)
            for child in node.orelse:
                walk(child, shielded)
            return
        for child in ast.iter_child_nodes(node):
            walk(child, shielded)

    for n in body:
        walk(n, False)
    return found


class _Unliftable(Exception):
    """An escape sits inside a construct the flag rewrite can't lift
    (try/with/match/...) — the caller keeps the python loop."""


def _flag_assign(name: str) -> ast.stmt:
    return ast.Assign(targets=[_name(name, ast.Store())],
                      value=ast.Constant(value=True))


def _lower_loop_escapes(body, brk: str, esc: str):
    """Lower every statement-level ``break``/``continue`` belonging to
    this loop — bare, with statements before/after it in the same branch,
    under ``else``, or in arbitrarily nested if/elif chains — to two
    flags (the reference's BreakContinueTransformer shapes,
    ``python/paddle/jit/dy2static/break_continue_transformer.py``):

    - ``break``     ->  ``esc = True; brk = True``
    - ``continue``  ->  ``esc = True``

    Statements after an escape are dropped (unreachable); statements
    after an escape-CAPABLE ``if`` are wrapped in ``if not esc:`` so the
    rest of the iteration is skipped once a flag fired. The caller
    prepends ``esc = False`` to the body (per-iteration reset), augments
    the loop test with ``not brk`` when any break exists, and guards a
    loop-``else`` with ``not brk``.

    Returns ``(new_body, used_break)``; raises ``_Unliftable`` for an
    escape buried in a non-``if`` compound statement.
    """
    out, used_break = [], False
    for i, st in enumerate(body):
        if isinstance(st, ast.Break):
            out.append(_flag_assign(esc))
            out.append(_flag_assign(brk))
            return out, True  # anything after is unreachable
        if isinstance(st, ast.Continue):
            out.append(_flag_assign(esc))
            return out, used_break
        if _own_escapes([st]):
            if not isinstance(st, ast.If):
                raise _Unliftable
            b_new, b_brk = _lower_loop_escapes(st.body, brk, esc)
            o_new, o_brk = _lower_loop_escapes(st.orelse, brk, esc)
            rest, r_brk = _lower_loop_escapes(body[i + 1:], brk, esc)
            used_break = used_break or b_brk or o_brk or r_brk
            out.append(ast.If(test=st.test, body=b_new,
                              orelse=o_new))
            if rest:
                out.append(ast.If(
                    test=_jst_call("logical_not", [_name(esc)]),
                    body=rest, orelse=[]))
            return out, used_break
        out.append(st)
    return out, used_break


def _read_names(nodes) -> set:
    """Names READ anywhere in ``nodes`` (Load/Del contexts, augmented
    targets — ``y += 1`` reads y — plus global/nonlocal declarations);
    crosses nested scopes on purpose — a closure's free-variable read
    keeps the name live."""
    out = set()
    for n in nodes:
        for sub in ast.walk(n):
            if isinstance(sub, ast.Name) and isinstance(
                    sub.ctx, (ast.Load, ast.Del)):
                out.add(sub.id)
            elif isinstance(sub, ast.AugAssign) and isinstance(
                    sub.target, ast.Name):
                out.add(sub.target.id)
            elif isinstance(sub, (ast.Global, ast.Nonlocal)):
                out.update(sub.names)
    return out


def _deferred_reads(stmts) -> set:
    """Reads inside NESTED SCOPES anywhere in ``stmts``: a closure defined
    before a converted if reads its free variables at CALL time, which may
    be after it — backward statement-order liveness alone would miss it."""
    out = set()
    for n in stmts:
        for sub in ast.walk(n):
            if isinstance(sub, _SCOPE_NODES):
                out |= _read_names([sub])
    return out


class _CtrlFlowTransformer:
    """Bottom-up statement rewrite of If/While/For into _jst dispatch.

    Blocks are processed in REVERSE so each statement knows the set of
    names read after it (syntactic liveness): only those are threaded
    through the extracted branch/body functions. Over-carrying is not
    just waste — a name assigned in one branch only and never read again
    (the shape return-lowering produces) would ride the torch.cond outputs
    as UNDEF on one side and a tensor on the other, crashing the trace.
    """

    def __init__(self):
        self.changed = False
        self._n = 0

    def _uid(self) -> int:
        self._n += 1
        return self._n

    def visit(self, fdef):
        fdef.body = self._block(fdef.body, set())
        return fdef

    def _block(self, stmts, live_after):
        # nested-scope reads are live EVERYWHERE in the block (late-bound
        # closures), not just above their def statement
        live = set(live_after) | _deferred_reads(stmts)
        processed = []
        for st in reversed(stmts):
            # capture reads BEFORE _stmt mutates the node: a detached
            # loop-else (moved into a trailer list) must keep its reads
            # visible to the liveness of earlier statements
            reads = _read_names([st])
            processed.append(self._stmt(st, set(live)))
            live |= reads
        out = []
        for repl in reversed(processed):
            out.extend(repl)
        return out

    def _stmt(self, st, live):
        if isinstance(st, ast.If):
            return self._conv_if(st, live)
        if isinstance(st, ast.While):
            return self._conv_while(st, live)
        if isinstance(st, ast.For):
            return self._conv_for(st, live)
        return self._generic(st, live)

    def _generic(self, st, live):
        """Recurse into any other compound statement's blocks. Inner
        positions see a conservative live set: everything live after the
        statement plus everything the statement itself reads (covers
        loop-back reads, handler reads, with-exit reads)."""
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
            st.body = self._block(st.body, set())  # fresh scope
            return [st]
        inner_live = live | _read_names([st])
        for field in ("body", "orelse", "finalbody"):
            block = getattr(st, field, None)
            if isinstance(block, list) and block and \
                    isinstance(block[0], ast.stmt):
                setattr(st, field, self._block(block, inner_live))
        for handler in getattr(st, "handlers", []):
            handler.body = self._block(handler.body, inner_live)
        for case in getattr(st, "cases", []):  # match statements
            case.body = self._block(case.body, inner_live)
        return [st]

    def _conv_if(self, node: ast.If, live):
        node.body = self._block(node.body, live)
        node.orelse = self._block(node.orelse, live)
        if _unconvertible(node.body + node.orelse, loops_shield=True):
            return [node]
        carried = sorted(_assigned_names(node.body + node.orelse) & live)
        uid = self._uid()
        tname, fname = f"_d2s_true_{uid}", f"_d2s_false_{uid}"
        tdef = _fn_def(tname, carried, node.body, carried)
        fdef = _fn_def(fname, carried, node.orelse or [ast.Pass()], carried)
        call = _jst_call("convert_if", [
            node.test, _name(tname), _name(fname),
            ast.Tuple(elts=[_maybe_call(c) for c in carried],
                      ctx=ast.Load())])
        self.changed = True
        return [tdef, fdef, _result_stmt(carried, call)]

    def _conv_while(self, node: ast.While, live, bound_expr=None):
        import copy

        # break/continue in the body lower to flag/guard form when that
        # makes the loop convertible; otherwise the original body is kept
        # (python loop, exact semantics). A loop-`else` detaches to a
        # trailer: unconditional when the body cannot break, guarded by
        # `not brk` when it can (python runs the else only on a
        # non-break exit, including the zero-trip one).
        prelude, trailer = [], []
        has_escapes = _own_escapes(node.body)
        # lowering must respect one conversion bail-out up front: a
        # walrus in the test would move its binding into the synthesized
        # lambda's scope
        if has_escapes and not _contains([node.test], ast.NamedExpr):
            uid = self._uid()
            flag = f"__break_flag_{uid}__"
            escf = f"__esc_flag_{uid}__"
            try:
                lowered, used_break = _lower_loop_escapes(
                    copy.deepcopy(node.body), flag, escf)
            except _Unliftable:
                lowered = None
            if lowered is not None and not _unconvertible(
                    lowered, loops_shield=True):
                # esc resets every iteration; brk persists across them
                node.body = [ast.Assign(
                    targets=[_name(escf, ast.Store())],
                    value=ast.Constant(value=False))] + lowered
                if used_break:
                    # while (not flag) and (test): the thunk keeps the
                    # original test un-evaluated once the break fired
                    node.test = _jst_call("logical_and", [
                        _jst_call("logical_not", [_name(flag)]),
                        ast.Lambda(
                            args=ast.arguments(
                                posonlyargs=[], args=[], kwonlyargs=[],
                                kw_defaults=[], defaults=[]),
                            body=node.test)])
                    prelude = [ast.Assign(
                        targets=[_name(flag, ast.Store())],
                        value=ast.Constant(value=False))]
                    if node.orelse:
                        trailer = [ast.If(
                            test=_jst_call("logical_not", [_name(flag)]),
                            body=node.orelse, orelse=[])]
                        node.orelse = []
                elif node.orelse:
                    # continue-only body: the else always runs on exit
                    trailer = list(node.orelse)
                    node.orelse = []
        elif node.orelse and not has_escapes:
            # no escapes at all: the else is an unconditional epilogue
            # (an exception or return inside the body skips a real
            # while-else AND a trailing statement identically)
            trailer = list(node.orelse)
            node.orelse = []
        if trailer:
            trailer = self._block(trailer, set(live))

        # body statements may be read by the NEXT iteration, the test, or
        # the (possibly detached) else block
        loop_live = live | _read_names(node.body + node.orelse
                                       + [node.test] + trailer)
        node.body = self._block(node.body, loop_live)
        if (node.orelse or _unconvertible(node.body, loops_shield=True)
                # a walrus in the test would bind inside the extracted
                # test_fn and never reach the body/enclosing scope
                or _contains([node.test], ast.NamedExpr)):
            node.orelse = self._block(node.orelse, live)
            return prelude + [node] + trailer
        carried = sorted((_assigned_names(node.body) |
                          _assigned_names([node.test])) & loop_live)
        if not carried:
            # stateless while: nothing to thread, leave as-is
            return prelude + [node] + trailer
        uid = self._uid()
        test_name, body_name = f"_d2s_wtest_{uid}", f"_d2s_wbody_{uid}"
        tdef = ast.FunctionDef(
            name=test_name,
            args=ast.arguments(
                posonlyargs=[], kwonlyargs=[], kw_defaults=[], defaults=[],
                args=[ast.arg(arg=p) for p in carried]),
            body=[ast.Return(value=node.test)], decorator_list=[])
        bdef = _fn_def(body_name, carried, node.body, carried)
        call = _jst_call("convert_while", [
            _name(test_name), _name(body_name),
            ast.Tuple(elts=[_maybe_call(c) for c in carried],
                      ctx=ast.Load()),
            bound_expr or _name("_d2s_loop_bound")])
        self.changed = True
        return prelude + [tdef, bdef, _result_stmt(carried, call)] + trailer

    def _conv_for(self, node: ast.For, live):
        # `for i in range(...)` with break/continue: rewrite to the while
        # form and reuse its escape lowering (paddle transforms for-range
        # the same way). The counter pre-increments — `tgt = i; i += step`
        # BEFORE the user body — so a lowered `continue` (which guards the
        # remaining body) can never skip the advance:
        #     i = start
        #     while range_cond(i, stop, step):
        #         tgt = i; i = i + step
        #         <user body>
        if (isinstance(node.iter, ast.Call)
                and isinstance(node.iter.func, ast.Name)
                and node.iter.func.id == "range" and not node.iter.keywords
                and 1 <= len(node.iter.args) <= 3
                and not any(isinstance(x, ast.Starred)
                            for x in node.iter.args)
                and isinstance(node.target, ast.Name)
                # an else reading the loop target would see UNDEF on a
                # zero-trip loop (python raises UnboundLocalError there) —
                # same refusal as the non-range detach below
                and not (node.orelse
                         and node.target.id in _read_names(node.orelse))
                and _own_escapes(node.body)):
            uid = self._uid()
            i_n = f"__for_i_{uid}__"
            stop_n = f"__for_stop_{uid}__"
            step_n = f"__for_step_{uid}__"
            a = node.iter.args
            start = a[0] if len(a) >= 2 else ast.Constant(value=0)
            stop = a[1] if len(a) >= 2 else a[0]
            step = a[2] if len(a) == 3 else ast.Constant(value=1)
            bound_n = f"__for_bound_{uid}__"
            # python evaluates range args left-to-right: start, stop, step
            # (a walrus in start may bind a name stop reads). The natural
            # trip bound is computed up front (i_n still holds start): a
            # user loop_bound sized for unbounded whiles must not truncate
            # this statically-counted loop, and calling range() here keeps
            # python's argument validation
            prelude = [
                ast.Assign(targets=[_name(i_n, ast.Store())], value=start),
                ast.Assign(targets=[_name(stop_n, ast.Store())], value=stop),
                ast.Assign(targets=[_name(step_n, ast.Store())], value=step),
                ast.Assign(targets=[_name(bound_n, ast.Store())],
                           value=_jst_call("range_trip_bound", [
                               _name(i_n), _name(stop_n), _name(step_n),
                               _name("_d2s_loop_bound")])),
            ]
            advance = [
                ast.Assign(targets=[ast.Name(id=node.target.id,
                                             ctx=ast.Store())],
                           value=_name(i_n)),
                ast.Assign(targets=[_name(i_n, ast.Store())],
                           value=ast.BinOp(left=_name(i_n), op=ast.Add(),
                                           right=_name(step_n))),
            ]
            wnode = ast.While(
                test=_jst_call("range_cond",
                               [_name(i_n), _name(stop_n), _name(step_n)]),
                body=advance + node.body, orelse=node.orelse)
            return prelude + self._conv_while(wnode, live,
                                              bound_expr=_name(bound_n))

        # escapes over a NON-range iterable: dispatch on indexability at
        # RUNTIME — length-immutable sequences/arrays rewrite to the
        # for-range form above (iteration IS indexing there, and that
        # form's escape lowering then applies); everything else keeps the
        # exact python loop. The else-reads-target refusal matches the
        # range branch (zero-trip UNDEF vs python's UnboundLocalError).
        # COST: the body is emitted twice (indexed copy + python
        # fallback), so K nested escape-bearing for-over-iterable loops
        # grow the rebuilt source by 2^K copies of the innermost body —
        # acceptable for the 1-2 deep loops models write.
        if (_own_escapes(node.body) and isinstance(node.target, ast.Name)
                and not getattr(node, "_d2s_no_dispatch", False)
                and not (node.orelse
                         and node.target.id in _read_names(node.orelse))):
            import copy

            uid = self._uid()
            seq_n = f"__for_seq_{uid}__"
            idx_n = f"__for_ix_{uid}__"
            indexed = ast.For(
                target=ast.Name(id=idx_n, ctx=ast.Store()),
                iter=ast.Call(func=_name("range"),
                              args=[_jst_call("seq_len", [_name(seq_n)])],
                              keywords=[]),
                body=[ast.Assign(
                    targets=[ast.Name(id=node.target.id, ctx=ast.Store())],
                    value=ast.Subscript(value=_name(seq_n),
                                        slice=_name(idx_n),
                                        ctx=ast.Load()))]
                + copy.deepcopy(node.body),
                orelse=copy.deepcopy(node.orelse))
            fallback = ast.For(target=node.target, iter=_name(seq_n),
                               body=node.body, orelse=node.orelse)
            fallback._d2s_no_dispatch = True  # break the rewrite recursion
            dispatch = ast.If(
                test=_jst_call("can_index", [_name(seq_n)]),
                body=[indexed], orelse=[fallback])
            prelude = [ast.Assign(targets=[_name(seq_n, ast.Store())],
                                  value=node.iter)]
            return prelude + self._stmt(dispatch, live)

        # a for-else with no break in the body is an unconditional
        # epilogue — detach it so the loop itself stays convertible. NOT
        # when the else reads the loop target: a converted loop's target
        # is body-local (carried excludes it), so the else would see a
        # stale pre-loop binding; keeping the else attached forces the
        # exact python path instead
        trailer = []
        if node.orelse and not _own_escapes(node.body):
            tgt = node.target.id if isinstance(node.target, ast.Name) \
                else None
            if tgt is None or tgt not in _read_names(node.orelse):
                trailer = self._block(list(node.orelse), set(live))
                node.orelse = []
        loop_live = live | _read_names(node.body + node.orelse
                                       + [node.iter] + trailer)
        node.body = self._block(node.body, loop_live)
        if (node.orelse or not isinstance(node.target, ast.Name)
                or _unconvertible(node.body, loops_shield=True)):
            node.orelse = self._block(node.orelse, live)
            return [node] + trailer
        target = node.target.id
        carried = sorted((_assigned_names(node.body) - {target}) & loop_live)
        uid = self._uid()
        body_name = f"_d2s_fbody_{uid}"
        bdef = _fn_def(body_name, [target] + carried, node.body, carried)
        it = node.iter
        if (isinstance(it, ast.Call) and isinstance(it.func, ast.Name)
                and it.func.id == "range" and not it.keywords):
            it = _jst_call("make_range", it.args)
        call = _jst_call("convert_for", [
            it, _name(body_name),
            ast.Tuple(elts=[_maybe_call(c) for c in carried],
                      ctx=ast.Load())])
        self.changed = True
        return [bdef, _result_stmt(carried, call)] + trailer


# ------------------------------------------------------ conversion entry
_MODULE_IDS = itertools.count()

def convert_control_flow(fn, loop_bound=None):
    """Return ``fn`` rewritten so tensor-dependent control flow lowers to
    ``torch.cond`` / ``while_loop`` when it is captured; returns ``fn`` unchanged when there is nothing to convert or
    its source is unavailable (lambdas, C extensions, exec'd code).

    ``loop_bound``: bake a max iteration count into every converted
    ``while`` — under capture it lowers to a masked loop of that length, which
    IS reverse-mode differentiable (the reference's ``while_grad``
    equivalent), at the cost of always spending ``loop_bound`` steps of
    compute. Loops that would run longer are truncated — size it like the
    reference sizes an unrolled RNN length.
    """
    if getattr(fn, "__d2s_converted__", False) or \
            getattr(fn, "__not_to_static__", False):
        return fn
    if hasattr(fn, "__wrapped__"):
        # a functools.wraps wrapper: getsource would see through to the
        # inner function and the rebuild would silently drop the wrapper
        return fn
    if (inspect.isgeneratorfunction(fn) or inspect.iscoroutinefunction(fn)
            or inspect.isasyncgenfunction(fn)):
        return fn  # yields/awaits cannot be moved into extracted fns
    try:
        src = textwrap.dedent(inspect.getsource(fn))
        tree = ast.parse(src)
    except (OSError, TypeError, SyntaxError, IndentationError):
        return fn
    fdef = tree.body[0]
    if not isinstance(fdef, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return fn
    # only the conversion entry points may be stripped from the source;
    # any other decorator's behavior would be silently lost in the rebuild
    _SAFE_DECOS = {"to_static", "jit", "not_to_static"}

    def _deco_tail(d):
        while isinstance(d, ast.Call):
            d = d.func
        return d.attr if isinstance(d, ast.Attribute) else \
            d.id if isinstance(d, ast.Name) else None

    if any(_deco_tail(d) not in _SAFE_DECOS for d in fdef.decorator_list):
        return fn
    if _contains([fdef], (ast.Yield, ast.YieldFrom, ast.Await)):
        return fn
    # zero-arg super() / __class__ need the compiler's implicit class cell,
    # which the factory rebuild cannot reproduce
    for sub in ast.walk(fdef):
        if isinstance(sub, ast.Name) and sub.id in ("super", "__class__"):
            return fn
    fdef.decorator_list = []  # the conversion entry must not re-apply
    fdef = _lower_returns(fdef)
    transformer = _CtrlFlowTransformer()
    fdef = transformer.visit(fdef)
    if not transformer.changed:
        return fn

    # wrap in a factory taking the original free variables, so the rebuilt
    # function keeps its closure bindings (cell contents snapshotted)
    freevars = fn.__code__.co_freevars
    factory_name = "_d2s_factory"
    factory = ast.FunctionDef(
        name=factory_name,
        args=ast.arguments(
            posonlyargs=[], kwonlyargs=[], kw_defaults=[], defaults=[],
            args=[ast.arg(arg=v) for v in freevars]),
        body=[fdef, ast.Return(value=_name(fdef.name))],
        decorator_list=[])
    module = ast.Module(body=[factory], type_ignores=[])
    ast.fix_missing_locations(module)
    try:
        code = compile(module, filename=f"<dy2static:{fn.__qualname__}>",
                       mode="exec")
    except SyntaxError:  # construct we mis-rebuilt: keep original behavior
        _log.warning("dy2static: could not recompile %s; control flow "
                     "stays trace-only", fn.__qualname__)
        return fn
    if CODE_LEVEL:
        _log.info("dy2static transformed %s:\n%s", fn.__qualname__,
                  ast.unparse(module))
    # the rebuilt function's globals: a snapshot of the original's, plus
    # the helpers, as the namespace of a module of its own, registered so
    # that dynamo (which traces the branches of torch.cond and
    # while_loop) finds them where the function's ``__name__`` points
    mod = types.ModuleType(f"_dy2static_{next(_MODULE_IDS)}")
    glb = mod.__dict__
    glb.update(fn.__globals__)
    glb["__name__"] = mod.__name__
    from . import dy2static as _self

    glb["_jst"] = _self
    glb["_d2s_loop_bound"] = (None if loop_bound is None
                              else int(loop_bound))
    sys.modules[mod.__name__] = mod
    exec(code, glb)
    cells = [c.cell_contents for c in (fn.__closure__ or ())]
    new_fn = glb[factory_name](*cells)
    functools.update_wrapper(new_fn, fn)
    new_fn.__d2s_converted__ = True
    new_fn.__d2s_loop_bound__ = loop_bound
    return new_fn


def convert_layer(layer, loop_bound=None) -> None:
    """Patch ``layer.forward`` in place with its converted version (the
    reference's StaticFunction patching on ``paddle.jit.to_static(layer)``)."""
    fwd = type(layer).forward
    conv = convert_control_flow(fwd, loop_bound=loop_bound)
    if conv is not fwd:
        layer.forward = types.MethodType(conv, layer)
