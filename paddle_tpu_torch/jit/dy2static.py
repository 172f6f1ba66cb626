"""dy2static: data-dependent Python control flow, converted to graph ops.

Counterpart of ``paddle_tpu/jit/dy2static.py``, statement for statement:
one AST pass rewrites ``if <Tensor>`` / ``while <Tensor>`` / ``for i in
range(<Tensor>)`` into calls that dispatch at run time.  A Python-valued
condition runs as plain Python (the trace unrolls it); a ``Variable``
condition builds the port's ``static.control_flow.cond`` /
``while_loop`` ops.  ``break`` / ``continue`` convert through per-loop
flags, ``return`` inside a loop through per-site flags with the return
expression deferred past the loop, and ``list.append`` / ``pop`` dispatch
at run time; what cannot convert raises :class:`ConversionError` naming
the source line.
"""

from __future__ import annotations

import ast
import functools
import inspect
import sys
import textwrap
from typing import Callable, List, Optional

import numpy as np

__all__ = ["ConversionError", "convert_func", "convert_ifelse",
           "convert_while", "Undefined"]


class ConversionError(RuntimeError):
    """A Python construct cannot be converted to static control flow."""


class Undefined:
    """Placeholder for a name not yet bound when a converted region starts
    (the reference's ``UndefinedVar``).  Any use raises."""

    def __init__(self, name: str):
        self._name = name

    def _raise(self, *_a, **_k):
        raise NameError(
            f"variable '{self._name}' is referenced before assignment "
            f"(it was only assigned on one path of converted control flow)")

    __bool__ = __call__ = __add__ = __radd__ = __mul__ = _raise
    __sub__ = __getitem__ = __getattr__ = _raise  # type: ignore[assignment]

    def __repr__(self):
        return f"<undefined '{self._name}'>"


def capture_args(*thunks):
    """Evaluate name-reading thunks, mapping unbound names to
    :class:`Undefined` so converted regions can assign them fresh."""
    out = []
    for t in thunks:
        try:
            out.append(t())
        except (NameError, UnboundLocalError):
            name = t.__code__.co_names or t.__code__.co_freevars or ("?",)
            out.append(Undefined(name[0]))
    return tuple(out)


def _is_symbolic(v) -> bool:
    from ..framework.program import Variable

    return isinstance(v, Variable)


def _promote(v):
    """Lift a Python/numpy value into the static graph (loop carries and
    branch outputs must be Variables)."""
    if _is_symbolic(v):
        return v
    if isinstance(v, Undefined):
        v._raise()
    from .. import tensor_api as T

    host = np.asarray(v)
    if host.ndim == 0:
        host = host.reshape([1])
    return T.assign(host)


def convert_ifelse(pred, true_fn: Callable, false_fn: Callable, vals,
                   merge: bool = False):
    """Runtime dispatch for a converted ``if``: Python value -> plain
    Python branch; static Variable -> in-graph ``cond``.

    The branch functions take ``vals`` (the names either branch assigns,
    as they stand before the ``if``).  Assignment form: they return the
    tuple of those names.  Return-merge form (``merge``, or no ``vals``):
    both source branches ended in ``return`` and the returned value is
    passed through."""
    from ..framework import program as fw

    if not _is_symbolic(pred):
        return true_fn(*vals) if _truth(pred) else false_fn(*vals)
    if fw.in_dygraph_mode():  # defensive: symbolic pred implies static
        raise ConversionError("symbolic predicate outside static mode")
    from ..static.control_flow import cond as static_cond

    def _norm(fn):
        def run():
            out = fn(*vals)
            seq = list(out) if isinstance(out, (list, tuple)) else [out]
            return [_promote(v) for v in seq]

        return run

    outs = static_cond(pred, _norm(true_fn), _norm(false_fn))
    outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
    if merge or not vals:  # return-merge form: the single merged value
        return outs[0] if len(outs) == 1 else tuple(outs)
    return tuple(outs)


def convert_while(cond_fn: Callable, body_fn: Callable, vals):
    """Runtime dispatch for a converted ``while``: probe the condition
    once; a Python-bool condition runs the loop in Python (trace-time
    unrolling), a Variable condition lowers to ``while_loop``."""
    from ..framework import program as fw

    vals = list(vals)
    if fw.in_dygraph_mode():
        while _truth(cond_fn(*vals)):
            vals = list(body_fn(*vals))
        return tuple(vals)

    block = fw.default_main_program().current_block()
    start = len(block.ops)
    probe = cond_fn(*vals)
    if not _is_symbolic(probe):
        del block.ops[start:]  # no ops should exist, but be safe
        while True:
            if _is_symbolic(probe):
                # the condition TURNED symbolic mid-unroll (e.g. `while
                # True` whose break flag became a Variable): the python-
                # unrolled iterations so far are a valid trace prefix —
                # drop this probe's ops (while_loop re-captures the
                # condition) and lower the REST as an in-graph while_loop
                del block.ops[start:]
                return _symbolic_while(cond_fn, body_fn, vals)
            if not _truth(probe):
                break
            vals = list(body_fn(*vals))
            start = len(block.ops)  # ops up to here are the live prefix
            probe = cond_fn(*vals)
        return tuple(vals)
    del block.ops[start:]  # drop probe ops; while_loop re-captures
    return _symbolic_while(cond_fn, body_fn, vals)


def _symbolic_while(cond_fn, body_fn, vals):
    from ..static.control_flow import while_loop

    sym_vals = [_promote(v) for v in vals]

    global _sym_loop_depth

    def _cond(*a):
        return cond_fn(*a)

    def _body(*a):
        global _sym_loop_depth
        _sym_loop_depth += 1
        try:
            # promote Python values the body re-binds (e.g. the break/
            # continue flag resets) — every carried value must be a Variable
            return [_promote(v) for v in body_fn(*a)]
        finally:
            _sym_loop_depth -= 1

    outs = while_loop(_cond, _body, sym_vals)
    return tuple(outs)


def _truth(v):
    from ..dygraph.tensor import Tensor

    if isinstance(v, Tensor):  # an eager Tensor: its first value
        return bool(np.asarray(v.numpy()).reshape(-1)[0])
    return bool(v)


def loop_test(test, brk):
    """Combined loop condition ``test and not brk`` that works for Python
    bools AND symbolic Variables (the break/continue transform's loop
    gate — reference break_continue_transformer role)."""
    if _is_symbolic(test) or _is_symbolic(brk):
        from .. import tensor_api as T

        t = test if _is_symbolic(test) else _promote(bool(_truth(test)))
        b = brk if _is_symbolic(brk) else _promote(bool(_truth(brk)))
        return T.logical_and(T.cast(t, "bool"),
                             T.logical_not(T.cast(b, "bool")))
    return _truth(test) and not _truth(brk)


def any_flag(*flags):
    """Logical OR of break/return flags — symbolic-safe (python `not`/`or`
    on a Variable would hit the __bool__ guard)."""
    if any(_is_symbolic(f) for f in flags):
        from .. import tensor_api as T

        acc = None
        for f in flags:
            fv = f if _is_symbolic(f) else _promote(bool(_truth(f)))
            fv = T.cast(fv, "bool")
            acc = fv if acc is None else T.logical_or(acc, fv)
        return acc
    return any(_truth(f) for f in flags)


def flags_clear(*flags):
    """True while none of the break/continue flags is set; symbolic when
    any flag is a Variable (guards the statements after a conditional
    break/continue)."""
    if any(_is_symbolic(f) for f in flags):
        from .. import tensor_api as T

        acc = None
        for f in flags:
            fv = f if _is_symbolic(f) else _promote(bool(_truth(f)))
            fv = T.cast(fv, "bool")
            acc = fv if acc is None else T.logical_or(acc, fv)
        return T.logical_not(acc)
    return not any(_truth(f) for f in flags)


# list op conversion (reference list_transformer / convert_operators role):
# python lists keep python semantics everywhere EXCEPT inside a symbolic
# (in-graph) while, where an append would silently run once at trace time —
# that case raises with the supported alternative.
_sym_loop_depth = 0


def convert_append(obj, x):
    if isinstance(obj, list):
        if _sym_loop_depth > 0:
            # ANY append inside an in-graph loop body runs exactly once at
            # trace time — silently wrong regardless of the payload type
            raise ConversionError(
                "list.append inside a TENSOR-bounded loop cannot grow a "
                "Python list in-graph; preallocate with paddle.zeros and "
                "write slices, or keep the loop bound a Python int "
                "(trace-time unrolling)")
        obj.append(x)
        return None
    return obj.append(x)


def convert_pop(obj, *args):
    if isinstance(obj, list) and _sym_loop_depth > 0:
        raise ConversionError(
            "list.pop inside a TENSOR-bounded loop is not convertible; "
            "keep the loop bound a Python int (trace-time unrolling)")
    return obj.pop(*args)


# ---------------------------------------------------------------------------
# AST transformation
# ---------------------------------------------------------------------------

_HELPER_NS = "_pt_dy2st"


def _assigned_names(stmts: List[ast.stmt]) -> List[str]:
    """Function-scope names assigned anywhere in ``stmts`` (nested defs and
    comprehensions have their own scope and are excluded)."""
    names: List[str] = []

    class V(ast.NodeVisitor):
        def _add(self, target):
            for node in ast.walk(target):
                if isinstance(node, ast.Name) and isinstance(
                        node.ctx, ast.Store):
                    if not node.id.startswith("_pt_") and node.id not in names:
                        names.append(node.id)

        def visit_Assign(self, node):
            for t in node.targets:
                self._add(t)
            self.generic_visit(node)

        def visit_AugAssign(self, node):
            self._add(node.target)
            self.generic_visit(node)

        def visit_AnnAssign(self, node):
            self._add(node.target)
            self.generic_visit(node)

        def visit_For(self, node):
            self._add(node.target)
            self.generic_visit(node)

        def visit_FunctionDef(self, node):  # new scope — skip
            pass

        def visit_AsyncFunctionDef(self, node):
            pass

        def visit_Lambda(self, node):
            pass

    v = V()
    for s in stmts:
        v.visit(s)
    return names


def _contains(stmts: List[ast.stmt], kinds) -> Optional[ast.stmt]:
    """First node of ``kinds`` in the statements' own scope (nested
    function/lambda scopes are not descended into)."""

    class Finder(ast.NodeVisitor):
        found: Optional[ast.stmt] = None

        def generic_visit(self, node):
            if self.found is not None:
                return
            if isinstance(node, kinds):
                self.found = node
                return
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                return  # new scope
            super().generic_visit(node)

    f = Finder()
    for s in stmts:
        f.generic_visit(s)
        if f.found is not None:
            return f.found
    return None


def _name(id_, ctx=None):
    return ast.Name(id=id_, ctx=ctx or ast.Load())


def _helper(attr):
    return ast.Attribute(value=_name(_HELPER_NS), attr=attr, ctx=ast.Load())


def _thunks(names: List[str]):
    """``capture_args(lambda: x, lambda: y, ...)`` call node."""
    lambdas = [
        ast.Lambda(
            args=ast.arguments(posonlyargs=[], args=[], kwonlyargs=[],
                               kw_defaults=[], defaults=[]),
            body=_name(n))
        for n in names
    ]
    return ast.Call(func=_helper("capture_args"), args=lambdas, keywords=[])


def _fn_def(fname: str, argnames: List[str], body: List[ast.stmt],
            returns: List[str]):
    ret = ast.Return(value=ast.Tuple(
        elts=[_name(n) for n in returns], ctx=ast.Load()))
    return ast.FunctionDef(
        name=fname,
        args=ast.arguments(
            posonlyargs=[],
            args=[ast.arg(arg=a) for a in argnames],
            kwonlyargs=[], kw_defaults=[], defaults=[]),
        body=body + [ret],
        decorator_list=[])


def _normalize_tail(body: List[ast.stmt]) -> List[ast.stmt]:
    """Rewrite early-exit ``if p: return a`` (+ fallthrough) into a
    balanced if/else whose branches BOTH end in return, so the transformer
    can merge them with ``convert_ifelse`` (the reference's
    return_transformer role).  Applies only at tail positions: the
    function body and branches of already-tail ifs — never inside loops."""
    out = list(body)
    for idx, s in enumerate(out):
        if not isinstance(s, ast.If):
            continue
        body_ret = bool(s.body) and isinstance(s.body[-1], ast.Return)
        orelse_ret = bool(s.orelse) and isinstance(s.orelse[-1], ast.Return)
        if not (body_ret or orelse_ret):
            continue  # no clean early-exit (buried returns error later)
        rest = out[idx + 1:]
        if rest:
            # attach the fallthrough to the branch that does not return;
            # when both already return, the fallthrough is dead code
            if not body_ret:
                s.body = s.body + rest
            elif not orelse_ret:
                s.orelse = (s.orelse or []) + rest
            out = out[:idx + 1]
        s.body = _normalize_tail(s.body)
        s.orelse = _normalize_tail(s.orelse) if s.orelse else []
        # a branch that still doesn't end in return falls off the function
        # end -> explicit ``return None`` so both branches merge
        if s.body and not isinstance(s.body[-1], ast.Return):
            s.body = s.body + [ast.copy_location(
                ast.Return(value=ast.Constant(value=None)), s)]
        if not s.orelse:
            s.orelse = [ast.copy_location(
                ast.Return(value=ast.Constant(value=None)), s)]
        elif not isinstance(s.orelse[-1], ast.Return):
            s.orelse = s.orelse + [ast.copy_location(
                ast.Return(value=ast.Constant(value=None)), s)]
        break  # everything after idx was folded in (or there was nothing)
    return out


class _Ctr:
    def __init__(self):
        self.n = 0

    def next(self):
        self.n += 1
        return self.n


def _stmt_sets_flag(st, brk, cont) -> bool:
    """Does this (already rewritten) statement possibly set a loop flag?
    (Nested loops own their breaks and are not descended into.)"""
    for node in ast.walk(st):
        if isinstance(node, (ast.While, ast.For, ast.FunctionDef,
                             ast.AsyncFunctionDef, ast.Lambda)):
            continue
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store) \
                and node.id in (brk, cont):
            return True
    return False


def _rewrite_break_continue(body, brk: str, cont: str):
    """Replace this loop's ``break``/``continue`` with flag assignments and
    guard every statement after a possible flag-set with
    ``if flags_clear(brk, cont):`` (the reference's
    break_continue_transformer strategy).  Nested loops keep their own
    break/continue untouched."""

    def set_flag(name, node):
        return ast.copy_location(
            ast.Assign(targets=[_name(name, ast.Store())],
                       value=ast.Constant(value=True)), node)

    def guard(stmts):
        out: List[ast.stmt] = []
        for i, st in enumerate(stmts):
            if isinstance(st, ast.Break):
                out.append(set_flag(brk, st))
                touched = True
            elif isinstance(st, ast.Continue):
                out.append(set_flag(cont, st))
                touched = True
            elif isinstance(st, ast.If):
                st.body = guard(st.body)
                st.orelse = guard(st.orelse) if st.orelse else []
                out.append(st)
                touched = _stmt_sets_flag(st, brk, cont)
            elif isinstance(st, (ast.With, ast.AsyncWith)):
                st.body = guard(st.body)
                out.append(st)
                touched = _stmt_sets_flag(st, brk, cont)
            elif isinstance(st, ast.Try):
                st.body = guard(st.body)
                st.orelse = guard(st.orelse) if st.orelse else []
                st.finalbody = guard(st.finalbody) if st.finalbody else []
                for h in st.handlers:
                    h.body = guard(h.body)
                out.append(st)
                touched = _stmt_sets_flag(st, brk, cont)
            else:
                out.append(st)  # nested loops keep their own break/continue
                touched = False
            rest = stmts[i + 1:]
            if touched and rest:
                g = ast.If(
                    test=ast.Call(func=_helper("flags_clear"),
                                  args=[_name(brk), _name(cont)],
                                  keywords=[]),
                    body=guard(rest), orelse=[])
                out.append(ast.copy_location(g, st))
                return out
        return out

    return guard(body)


def _loop_has_break(body) -> bool:
    """Break/Continue belonging to THIS loop (not a nested one)."""

    class F(ast.NodeVisitor):
        found = False

        def generic_visit(self, node):
            if self.found:
                return
            if isinstance(node, (ast.Break, ast.Continue)):
                self.found = True
                return
            if isinstance(node, (ast.While, ast.For, ast.FunctionDef,
                                 ast.AsyncFunctionDef, ast.Lambda)):
                return
            super().generic_visit(node)

    f = F()
    for s in body:
        f.generic_visit(s)
        if f.found:
            return True
    return False


class _ReturnInLoopTransformer(ast.NodeTransformer):
    """``return`` inside a loop (reference return_transformer role).

    Each return SITE gets its own flag; the return EXPRESSION is deferred
    to after the outermost enclosing loop:

        return e_k       ->  _retf_k = True; break
        <inner loop>     ->  <inner loop>; if not flags_clear(...): break
        <top loop>       ->  <top loop>;  if _retf_k: return e_k  (per k)

    Deferring ``e_k`` is exact because the synthesized break exits every
    loop level immediately — the locals ``e_k`` reads hold their values
    from the break iteration (they are the loop carries at exit).  This
    sidesteps carrying a value of unknown structure through a tensor-
    bounded while_loop: only boolean flags ride the carry, and the
    at-most-one-true flag picks the deferred expression after the loop
    (the per-site ifs chain through _normalize_tail's return merging)."""

    def __init__(self):
        self.depth = 0
        self.ctr = 0
        # per-loop-nesting stack of flag names created under that loop
        self.loop_flags: List[List[str]] = []
        # flags created at depth 1 loops (emit return-guards at top level)
        self.pending: List[tuple] = []
        self.rewrote = False

    def visit_FunctionDef(self, node):  # nested scopes keep their returns
        return node

    def visit_AsyncFunctionDef(self, node):
        return node

    def visit_Lambda(self, node):
        return node

    def visit_Return(self, node: ast.Return):
        if self.depth == 0:
            return node
        self.rewrote = True
        self.ctr += 1
        flag = f"_retf{self.ctr}"
        for level in self.loop_flags:
            level.append(flag)
        value = node.value if node.value is not None else ast.Constant(
            value=None)
        self.pending.append((flag, value))
        return [
            ast.copy_location(ast.Assign(
                targets=[_name(flag, ast.Store())],
                value=ast.Constant(value=True)), node),
            ast.copy_location(ast.Break(), node),
        ]

    def _visit_loop(self, node):
        self.depth += 1
        self.loop_flags.append([])
        self.generic_visit(node)
        flags = self.loop_flags.pop()
        self.depth -= 1
        if not flags:
            return node
        if self.depth > 0:
            # propagate the exit outward: break the enclosing loop too
            guard: ast.stmt = ast.If(
                test=ast.Call(func=_helper("any_flag"),
                              args=[_name(f) for f in flags], keywords=[]),
                body=[ast.Break()], orelse=[])
            return [node, ast.copy_location(guard, node)]
        # top level: one deferred-return guard per site (mutually exclusive
        # — a break exits every level before another site can fire)
        out: List[ast.stmt] = [node]
        for flag, value in self.pending:
            if flag in flags:
                out.append(ast.copy_location(ast.If(
                    test=_name(flag),
                    body=[ast.Return(value=value)], orelse=[]), node))
        self.pending = [(f, v) for f, v in self.pending if f not in flags]
        return out

    def visit_While(self, node):
        return self._visit_loop(node)

    def visit_For(self, node):
        return self._visit_loop(node)


def _rewrite_returns_in_loops(fdef: ast.FunctionDef) -> None:
    t = _ReturnInLoopTransformer()
    # transform the BODY statements (visit(fdef) would hit the nested-
    # scope skip on the function node itself)
    new_body: List[ast.stmt] = []
    for st in fdef.body:
        r = t.visit(st)
        new_body.extend(r if isinstance(r, list) else [r])
    fdef.body = new_body
    if t.rewrote:
        fdef.body = [
            ast.Assign(targets=[_name(f"_retf{k}", ast.Store())],
                       value=ast.Constant(value=False))
            for k in range(1, t.ctr + 1)
        ] + fdef.body


class _ControlFlowTransformer(ast.NodeTransformer):
    """Rewrite if/while/for statements into runtime-dispatched helpers."""

    def __init__(self, filename: str):
        self.filename = filename
        self.ctr = _Ctr()

    def _err(self, node, why) -> ConversionError:
        return ConversionError(
            f"{self.filename}:{getattr(node, 'lineno', '?')}: {why}")

    # -- if/elif/else ---------------------------------------------------
    def visit_If(self, node: ast.If):
        self.generic_visit(node)
        both_ret = (node.body and isinstance(node.body[-1], ast.Return)
                    and node.orelse
                    and isinstance(node.orelse[-1], ast.Return))
        ret_in_body = _contains(node.body + node.orelse, ast.Return)
        if ret_in_body is not None and not both_ret:
            raise self._err(
                ret_in_body,
                "'return' inside one branch of a convertible 'if' — either "
                "return from BOTH branches or assign to a variable and "
                "return after the if")
        k = self.ctr.next()
        tname, fname = f"_pt_true_{k}", f"_pt_false_{k}"
        if both_ret:
            # both branches return: the converted region returns the merge.
            # The names a branch assigns enter as arguments, so that a
            # branch may read a name before it rebinds it (``q = f(q)``)
            tbody = node.body[:-1] + [ast.Return(value=node.body[-1].value)]
            fbody = (node.orelse[:-1]
                     + [ast.Return(value=node.orelse[-1].value)])
            modified = sorted(set(_assigned_names(node.body)
                                  + _assigned_names(node.orelse)))

            def branch(name, body):
                return ast.FunctionDef(
                    name=name,
                    args=ast.arguments(
                        posonlyargs=[], args=[ast.arg(arg=a)
                                              for a in modified],
                        kwonlyargs=[], kw_defaults=[], defaults=[]),
                    body=body, decorator_list=[])

            tdef, fdef = branch(tname, tbody), branch(fname, fbody)
            call = ast.Call(
                func=_helper("convert_ifelse"),
                args=[node.test, _name(tname), _name(fname),
                      _thunks(modified), ast.Constant(value=True)],
                keywords=[])
            out: List[ast.stmt] = [tdef, fdef, ast.Return(value=call)]
            return [ast.copy_location(s, node) for s in out]

        modified = sorted(set(_assigned_names(node.body)
                              + _assigned_names(node.orelse)))
        if not modified:
            # side-effect-only branches (prints, list.append, method calls)
            # keep Python semantics; a symbolic pred will fail loudly in
            # Variable.__bool__ at trace time
            return node
        tdef = _fn_def(tname, modified, node.body or [ast.Pass()], modified)
        fdef = _fn_def(fname, modified, node.orelse or [ast.Pass()], modified)
        call = ast.Call(
            func=_helper("convert_ifelse"),
            args=[node.test, _name(tname), _name(fname), _thunks(modified)],
            keywords=[])
        target = ast.Tuple(elts=[_name(n, ast.Store()) for n in modified],
                           ctx=ast.Store())
        assign = ast.Assign(targets=[target], value=call)
        return [ast.copy_location(s, node) for s in (tdef, fdef, assign)]

    def _flagged_loop(self, node, k, extra_tail=None):
        """break/continue machinery shared by while and for-range: returns
        (prelude_stmts, test_expr, body_stmts).  ``extra_tail`` (the
        for-range index bump) runs every iteration a break did not end —
        including ones a `continue` cut short."""
        ret = _contains(node.body, ast.Return)
        if ret is not None:
            raise self._err(
                ret, "'return' inside a convertible loop is not convertible "
                     "— assign to a variable and return after the loop")
        body = list(node.body)
        test = node.test if isinstance(node, ast.While) else None
        prelude: List[ast.stmt] = []
        if _loop_has_break(body):
            brk, cont = f"_brk{k}", f"_cont{k}"
            # BOTH flags init in the prelude: the loop capture reads every
            # carried name before the first iteration runs
            for fname in (brk, cont):
                prelude.append(ast.Assign(
                    targets=[_name(fname, ast.Store())],
                    value=ast.Constant(value=False)))
            body = ([ast.Assign(targets=[_name(cont, ast.Store())],
                                value=ast.Constant(value=False))]
                    + _rewrite_break_continue(body, brk, cont))
            if extra_tail:
                # the bump must run unless the loop BROKE (a continue
                # still advances the index — Python for semantics)
                body = body + [ast.If(
                    test=ast.Call(func=_helper("flags_clear"),
                                  args=[_name(brk)], keywords=[]),
                    body=list(extra_tail), orelse=[])]
            test = ast.Call(func=_helper("loop_test"),
                            args=[test, _name(brk)], keywords=[])
        elif extra_tail:
            body = body + list(extra_tail)
        return prelude, test, body

    # -- while ----------------------------------------------------------
    def visit_While(self, node: ast.While):
        if node.orelse:
            raise self._err(node, "while/else is not convertible")
        k = self.ctr.next()
        prelude, test, body = self._flagged_loop(node, k)
        node.test, node.body = test, body
        self.generic_visit(node)
        cname, bname = f"_pt_cond_{k}", f"_pt_body_{k}"
        loop_vars = sorted(set(_assigned_names(node.body)))
        if not loop_vars:
            return node  # nothing carried: leave as Python
        cdef = ast.FunctionDef(
            name=cname,
            args=ast.arguments(
                posonlyargs=[], args=[ast.arg(arg=a) for a in loop_vars],
                kwonlyargs=[], kw_defaults=[], defaults=[]),
            body=[ast.Return(value=node.test)],
            decorator_list=[])
        bdef = _fn_def(bname, loop_vars, node.body, loop_vars)
        call = ast.Call(
            func=_helper("convert_while"),
            args=[_name(cname), _name(bname), _thunks(loop_vars)],
            keywords=[])
        if len(loop_vars) == 1:
            target: ast.expr = ast.Tuple(
                elts=[_name(loop_vars[0], ast.Store())], ctx=ast.Store())
        else:
            target = ast.Tuple(
                elts=[_name(n, ast.Store()) for n in loop_vars],
                ctx=ast.Store())
        assign = ast.Assign(targets=[target], value=call)
        return [ast.copy_location(s, node)
                for s in (prelude + [cdef, bdef, assign])]

    # -- list ops (reference list_transformer role) ----------------------
    def visit_Call(self, node: ast.Call):
        self.generic_visit(node)
        if (isinstance(node.func, ast.Attribute) and not node.keywords
                and ((node.func.attr == "append" and len(node.args) == 1)
                     or (node.func.attr == "pop" and len(node.args) <= 1))):
            helper = ("convert_append" if node.func.attr == "append"
                      else "convert_pop")
            return ast.copy_location(ast.Call(
                func=_helper(helper),
                args=[node.func.value] + list(node.args),
                keywords=[]), node)
        return node

    # -- for i in range(...) --------------------------------------------
    def visit_For(self, node: ast.For):
        is_range = (isinstance(node.iter, ast.Call)
                    and isinstance(node.iter.func, ast.Name)
                    and node.iter.func.id == "range"
                    and not node.iter.keywords
                    and 1 <= len(node.iter.args) <= 3
                    and isinstance(node.target, ast.Name))
        if not is_range:
            self.generic_visit(node)
            return node  # non-range for stays Python (trace-time unroll)
        if node.orelse:
            raise self._err(node, "for/else is not convertible")
        k = self.ctr.next()
        a = node.iter.args
        start = a[0] if len(a) >= 2 else ast.Constant(value=0)
        stop = a[1] if len(a) >= 2 else a[0]
        step = a[2] if len(a) == 3 else ast.Constant(value=1)
        sv, ev, tv = f"_pt_start_{k}", f"_pt_stop_{k}", f"_pt_step_{k}"
        i = node.target.id
        # `if step == 0: raise` mirrors Python's range() contract — without
        # it the synthesized while (i += 0 forever) would hang the trace.
        # For a concrete Python step this fires at trace time; a Tensor-
        # valued step hits the Tensor-__bool__ guard with its own error.
        zero_guard = ast.parse(
            f"if {tv} == 0:\n"
            f"    raise ValueError('range() arg 3 must not be zero')"
        ).body[0]
        prelude = [
            ast.Assign(targets=[_name(sv, ast.Store())], value=start),
            ast.Assign(targets=[_name(ev, ast.Store())], value=stop),
            ast.Assign(targets=[_name(tv, ast.Store())], value=step),
            zero_guard,
            ast.Assign(targets=[_name(i, ast.Store())], value=_name(sv)),
        ]
        # step-sign-aware loop test: `i < stop if step > 0 else i > stop`
        # (a bare `i < stop` silently runs ZERO iterations for a negative
        # step).  For the common symbolic case the step is still a Python
        # int, so the ternary resolves at trace time; a Tensor-valued step
        # hits the Variable-__bool__ guard with its standard error message.
        test = ast.IfExp(
            test=ast.Compare(left=_name(tv), ops=[ast.Gt()],
                             comparators=[ast.Constant(value=0)]),
            body=ast.Compare(left=_name(i), ops=[ast.Lt()],
                             comparators=[_name(ev)]),
            orelse=ast.Compare(left=_name(i), ops=[ast.Gt()],
                               comparators=[_name(ev)]))
        bump = ast.Assign(
            targets=[_name(i, ast.Store())],
            value=ast.BinOp(left=_name(i), op=ast.Add(), right=_name(tv)))
        # break/continue machinery BEFORE the while conversion; the bump is
        # the extra_tail so `continue` still advances the index
        tmp = ast.While(test=test, body=node.body, orelse=[])
        flag_prelude, test2, body2 = self._flagged_loop(tmp, k,
                                                        extra_tail=[bump])
        wh = ast.While(test=test2, body=body2, orelse=[])
        out = [ast.copy_location(s, node)
               for s in prelude + flag_prelude + [wh]]
        # now convert the while we just built
        res: List[ast.stmt] = []
        for s in out:
            r = self.visit(s) if isinstance(s, ast.While) else s
            res.extend(r if isinstance(r, list) else [r])
        return res


_CONVERT_CACHE = {}


def convert_func(fn: Callable) -> Callable:
    """Return ``fn`` rewritten for data-dependent control flow, or ``fn``
    unchanged when there is nothing to convert / no source available.

    Cache discipline: closure-free functions cache per code object; a
    function WITH free variables caches on the function object itself —
    factory-made functions share one code object across different closure
    cells (e.g. the generated activation forwards), so a code-keyed cache
    would silently hand one factory instance another instance's
    conversion.  Closure values are resolved at conversion time; mutating
    a cell after conversion is not reflected."""
    code = getattr(fn, "__code__", None)
    if code is None:
        return fn
    if not code.co_freevars:
        if code in _CONVERT_CACHE:
            return _CONVERT_CACHE[code]
        converted = _convert_uncached(fn)
        _CONVERT_CACHE[code] = converted
        return converted
    cached = getattr(fn, "__dy2static_conv__", None)
    if cached is not None:
        return cached
    converted = _convert_uncached(fn)
    try:
        fn.__dy2static_conv__ = converted
    except (AttributeError, TypeError):
        pass
    return converted


def _convert_uncached(fn: Callable) -> Callable:
    try:
        src = textwrap.dedent(inspect.getsource(fn))
        tree = ast.parse(src)
    except (OSError, TypeError, SyntaxError, IndentationError):
        return fn
    fdef = tree.body[0]
    if not isinstance(fdef, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return fn
    if not _contains(fdef.body, (ast.If, ast.While, ast.For)):
        return fn  # nothing to do
    if "__class__" in fn.__code__.co_freevars:
        # zero-arg super() needs the __class__ closure cell, which cannot
        # be rebuilt through exec; such methods keep Python semantics
        # (use super(Cls, self) if tensor control flow is also needed)
        return fn

    fdef.decorator_list = []  # drop @to_static etc. — we are past them
    _rewrite_returns_in_loops(fdef)  # return-in-loop -> flags + break
    fdef.body = _normalize_tail(fdef.body)
    filename = getattr(inspect.getmodule(fn), "__file__", None) or "<dy2st>"
    new_tree = _ControlFlowTransformer(filename).visit(tree)
    ast.fix_missing_locations(new_tree)

    # exec in the original globals + resolved closure cells, so module
    # imports and enclosing-scope names keep working
    glob = dict(fn.__globals__)
    if fn.__closure__:
        for name, cell in zip(fn.__code__.co_freevars, fn.__closure__):
            try:
                glob[name] = cell.cell_contents
            except ValueError:
                pass
    glob[_HELPER_NS] = sys.modules[__name__]
    code = compile(new_tree, filename=f"<dy2static {filename}>", mode="exec")
    ns = {}
    exec(code, glob, ns)
    out = ns[fdef.name]
    functools.update_wrapper(out, fn)
    out.__dy2static_converted__ = True
    return out
