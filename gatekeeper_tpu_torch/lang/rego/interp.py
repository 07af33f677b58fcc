"""Rego interpreter: backtracking evaluation over the parsed AST.

This is the *exact* evaluation path of the framework: every template runs here
unless its lowered vectorized program proves equivalent (the TPU driver uses
this interpreter both as fallback and as the differential-test oracle, mirroring
how the reference keeps the Rego engine authoritative while k8scel is additive).

Evaluation model: a rule body is a conjunction of goals; each goal is evaluated
as a generator of extended environments (standard logic-programming
backtracking).  References with unbound variables enumerate collections;
``not`` is negation-as-failure; partial set/object rules materialize on demand
and memoize per query.
"""

from __future__ import annotations

from typing import Any, Iterator, Optional

from gatekeeper_tpu_torch.lang.rego import ast
from gatekeeper_tpu_torch.lang.rego.builtins import REGISTRY
from gatekeeper_tpu_torch.lang.rego.parser import WithWrapped, parse_module
from gatekeeper_tpu_torch.lang.rego.value import (
    UNDEFINED,
    RegoSet,
    freeze,
    sorted_values,
    truthy,
)

MAX_DEPTH = 512


class RegoError(Exception):
    pass


class ConflictError(RegoError):
    pass


class UnsafeVarError(RegoError):
    pass


class _DataPath:
    """Unresolved pointer into the data document (base data + virtual docs)."""

    __slots__ = ("path",)

    def __init__(self, path: tuple = ()):  # noqa: D401
        self.path = path

    def child(self, k) -> "_DataPath":
        return _DataPath(self.path + (k,))


class ModuleSet:
    """Compiled set of modules indexed by package path."""

    def __init__(self, modules: list[ast.Module]):
        self.by_pkg: dict[tuple, ast.Module] = {}
        for m in modules:
            if m.package in self.by_pkg:
                # merge rules of same package (libs may share a package)
                existing = self.by_pkg[m.package]
                for name, rule in m.rules.items():
                    if name in existing.rules:
                        er = existing.rules[name]
                        if er.kind != rule.kind:
                            raise RegoError(
                                f"conflicting rule kinds for {name}"
                            )
                        er.clauses.extend(rule.clauses)
                        if rule.default is not None:
                            er.default = rule.default
                    else:
                        existing.rules[name] = rule
                existing.imports.update(m.imports)
            else:
                self.by_pkg[m.package] = m

    def packages_under(self, path: tuple) -> list[tuple]:
        return [p for p in self.by_pkg if p[: len(path)] == path and len(p) > len(path)]


def compile_modules(sources: list[str]) -> ModuleSet:
    return ModuleSet([parse_module(s) for s in sources])


class Interpreter:
    def __init__(self, modules: ModuleSet, data: Optional[dict] = None):
        self.modules = modules
        self.data = data if data is not None else {}

    def query_set_rule(self, package: tuple, rule_name: str, input_doc: Any) -> list:
        """Evaluate a partial set rule (e.g. ``violation``) to a list of values.

        Returns values in term-sorted order (OPA set iteration order).
        """
        ctx = _Ctx(self, input_doc)
        mod = self.modules.by_pkg.get(package)
        if mod is None:
            raise RegoError(f"no module for package {'.'.join(package)}")
        rule = mod.rules.get(rule_name)
        if rule is None:
            return []
        val = ctx.rule_value(mod, rule)
        if val is UNDEFINED:
            return []
        if isinstance(val, RegoSet):
            return sorted_values(val)
        return [val]

    def query_rule(self, package: tuple, rule_name: str, input_doc: Any) -> Any:
        ctx = _Ctx(self, input_doc)
        mod = self.modules.by_pkg.get(package)
        if mod is None:
            raise RegoError(f"no module for package {'.'.join(package)}")
        rule = mod.rules.get(rule_name)
        if rule is None:
            return UNDEFINED
        return ctx.rule_value(mod, rule)


class _Ctx:
    def __init__(self, interp: Interpreter, input_doc: Any):
        self.interp = interp
        self.modules = interp.modules
        self.input = input_doc
        self.data = interp.data
        self.rule_memo: dict = {}
        self.fn_memo: dict = {}
        self.depth = 0

    # ------------------------------------------------------------------
    # rule evaluation
    # ------------------------------------------------------------------
    def rule_value(self, mod: ast.Module, rule: ast.Rule) -> Any:
        key = (mod.package, rule.name)
        if key in self.rule_memo:
            v = self.rule_memo[key]
            if v is _IN_PROGRESS:
                raise RegoError(f"recursive rule {rule.name}")
            return v
        self.rule_memo[key] = _IN_PROGRESS
        try:
            val = self._compute_rule(mod, rule)
        finally:
            if self.rule_memo.get(key) is _IN_PROGRESS:
                del self.rule_memo[key]
        self.rule_memo[key] = val
        return val

    def _compute_rule(self, mod: ast.Module, rule: ast.Rule) -> Any:
        if rule.kind == "function":
            raise RegoError(f"function {rule.name} referenced without call")
        if rule.kind == "set":
            out = RegoSet()
            for clause in rule.clauses:
                for env in self.eval_body(mod, clause.body, {}):
                    v = self.eval_ground(mod, clause.key, env)
                    if v is not UNDEFINED:
                        out.add(v)
            return out
        if rule.kind == "object":
            out: dict = {}
            seen: dict = {}
            for clause in rule.clauses:
                for env in self.eval_body(mod, clause.body, {}):
                    k = self.eval_ground(mod, clause.key, env)
                    v = self.eval_ground(mod, clause.value, env)
                    if k is UNDEFINED or v is UNDEFINED:
                        continue
                    fk = freeze(k)
                    if fk in seen and freeze(seen[fk]) != freeze(v):
                        raise ConflictError(
                            f"object rule {rule.name}: conflicting values for key {k!r}"
                        )
                    seen[fk] = v
                    out[k if isinstance(k, (str, int, float, bool)) or k is None
                        else _freeze_key(k)] = v
            return out
        # complete rule
        result = UNDEFINED
        for clause in rule.clauses:
            v = self._eval_clause_chain(mod, clause)
            if v is UNDEFINED:
                continue
            if result is not UNDEFINED and freeze(result) != freeze(v):
                raise ConflictError(
                    f"complete rule {rule.name} produces multiple values"
                )
            result = v
        if result is UNDEFINED and rule.default is not None:
            result = self.eval_ground(mod, rule.default, {})
        return result

    def _eval_clause_chain(self, mod: ast.Module, clause: ast.Clause) -> Any:
        cur: Optional[ast.Clause] = clause
        while cur is not None:
            for env in self.eval_body(mod, cur.body, {}):
                if cur.value is None:
                    return True
                v = self.eval_ground(mod, cur.value, env)
                if v is not UNDEFINED:
                    return v
                break  # head undefined: fall to else
            cur = cur.els
        return UNDEFINED

    def call_function(self, mod: ast.Module, rule: ast.Rule, args: list) -> Any:
        # memoize scalar-arg calls only: freezing container args (e.g. whole
        # inventory objects in referential policies) costs far more than
        # re-evaluating the function body
        memo_key = None
        if not any(isinstance(a, (dict, list, tuple, RegoSet)) for a in args):
            memo_key = (mod.package, rule.name, freeze(tuple(args)))
            if memo_key in self.fn_memo:
                return self.fn_memo[memo_key]
        self.depth += 1
        if self.depth > MAX_DEPTH:
            raise RegoError("max evaluation depth exceeded")
        try:
            result = UNDEFINED
            for clause in rule.clauses:
                v = self._eval_fn_clause_chain(mod, clause, args)
                if v is UNDEFINED:
                    continue
                if result is not UNDEFINED and freeze(result) != freeze(v):
                    raise ConflictError(
                        f"function {rule.name} produces conflicting results"
                    )
                result = v
        finally:
            self.depth -= 1
        if memo_key is not None:
            self.fn_memo[memo_key] = result
        return result

    def _eval_fn_clause_chain(self, mod, clause: ast.Clause, args: list) -> Any:
        cur: Optional[ast.Clause] = clause
        while cur is not None:
            params = cur.args or ()
            if len(params) == len(args):
                for env0 in self._bind_params(mod, params, args, {}):
                    for env in self.eval_body(mod, cur.body, env0):
                        if cur.value is None:
                            return True
                        v = self.eval_ground(mod, cur.value, env)
                        if v is not UNDEFINED:
                            return v
                    break  # params bound once; body failed → try else
            cur = cur.els
        return UNDEFINED

    def _bind_params(self, mod, params, args, env) -> Iterator[dict]:
        if not params:
            yield env
            return
        for env2 in self.unify_value(mod, params[0], args[0], env):
            yield from self._bind_params(mod, params[1:], args[1:], env2)

    # ------------------------------------------------------------------
    # body / statement evaluation
    # ------------------------------------------------------------------
    def eval_body(self, mod, stmts, env: dict) -> Iterator[dict]:
        if not stmts:
            yield env
            return
        for env2 in self.eval_stmt(mod, stmts[0], env):
            yield from self.eval_body(mod, stmts[1:], env2)

    def eval_stmt(self, mod, stmt, env: dict) -> Iterator[dict]:
        if isinstance(stmt, WithWrapped):
            yield from self._eval_with(mod, stmt, env)
            return
        if isinstance(stmt, ast.ExprStmt):
            if stmt.negated:
                for _v, _e in self.eval_term(mod, stmt.term, env):
                    if truthy(_v):
                        return
                yield env
                return
            for v, env2 in self.eval_term(mod, stmt.term, env):
                if truthy(v):
                    yield env2
            return
        if isinstance(stmt, ast.AssignStmt):
            for v, env2 in self.eval_term(mod, stmt.term, env):
                yield from self.unify_value(mod, stmt.target, v, env2)
            return
        if isinstance(stmt, ast.UnifyStmt):
            yield from self.unify(mod, stmt.lhs, stmt.rhs, env)
            return
        if isinstance(stmt, ast.SomeDecl):
            env2 = dict(env)
            for n in stmt.names:
                env2.pop(n, None)
            yield env2
            return
        if isinstance(stmt, ast.SomeIn):
            for coll, env1 in self.eval_term(mod, stmt.collection, env):
                yield from self._enumerate_in(mod, stmt, coll, env1)
            return
        if isinstance(stmt, ast.EveryStmt):
            yield from self._eval_every(mod, stmt, env)
            return
        raise RegoError(f"unknown statement {stmt!r}")

    def _eval_with(self, mod, stmt: WithWrapped, env: dict) -> Iterator[dict]:
        saved_input, saved_data = self.input, self.data
        saved_memo, saved_fmemo = self.rule_memo, self.fn_memo
        try:
            for target, val_term in stmt.withs:
                val = self.eval_ground(mod, val_term, env)
                if target[0] == "input":
                    self.input = _override_path(self.input, target[1:], val)
                elif target[0] == "data":
                    self.data = _override_path(self.data, target[1:], val)
                else:
                    raise RegoError(f"with target {'.'.join(target)} unsupported")
            self.rule_memo, self.fn_memo = {}, {}
            yield from self.eval_stmt(mod, stmt.stmt, env)
        finally:
            self.input, self.data = saved_input, saved_data
            self.rule_memo, self.fn_memo = saved_memo, saved_fmemo

    def _enumerate_in(self, mod, stmt: ast.SomeIn, coll, env) -> Iterator[dict]:
        pairs: list[tuple[Any, Any]]
        if isinstance(coll, (list, tuple)):
            pairs = list(enumerate(coll))
        elif isinstance(coll, dict):
            pairs = list(coll.items())
        elif isinstance(coll, RegoSet):
            pairs = [(v, v) for v in coll]
        else:
            return
        for k, v in pairs:
            for env1 in self.unify_value(mod, stmt.value, v, env):
                if stmt.key is not None:
                    yield from self.unify_value(mod, stmt.key, k, env1)
                else:
                    yield env1

    def _eval_every(self, mod, stmt: ast.EveryStmt, env) -> Iterator[dict]:
        for coll, env1 in self.eval_term(mod, stmt.domain, env):
            if isinstance(coll, (list, tuple)):
                pairs = list(enumerate(coll))
            elif isinstance(coll, dict):
                pairs = list(coll.items())
            elif isinstance(coll, RegoSet):
                pairs = [(v, v) for v in coll]
            else:
                return
            ok = True
            for k, v in pairs:
                env2 = dict(env1)
                env2[stmt.value] = v
                if stmt.key:
                    env2[stmt.key] = k
                if not any(True for _ in self.eval_body(mod, stmt.body, env2)):
                    ok = False
                    break
            if ok:
                yield env1
            return

    # ------------------------------------------------------------------
    # term evaluation
    # ------------------------------------------------------------------
    def eval_ground(self, mod, term, env: dict) -> Any:
        """Evaluate a term expected to be ground; first solution or UNDEFINED."""
        for v, _ in self.eval_term(mod, term, env):
            return v
        return UNDEFINED

    def eval_term(self, mod, term, env: dict) -> Iterator[tuple[Any, dict]]:
        if isinstance(term, ast.Scalar):
            yield term.value, env
            return
        if isinstance(term, ast.Var):
            yield from self._eval_var(mod, term, env)
            return
        if isinstance(term, ast.Ref):
            yield from self._eval_ref(mod, term, env)
            return
        if isinstance(term, ast.ArrayTerm):
            yield from self._eval_seq(mod, term.items, env, list)
            return
        if isinstance(term, ast.SetTerm):
            yield from self._eval_seq(mod, term.items, env, RegoSet)
            return
        if isinstance(term, ast.ObjectTerm):
            yield from self._eval_object(mod, term, env)
            return
        if isinstance(term, ast.Call):
            yield from self._eval_call(mod, term, env)
            return
        if isinstance(term, ast.ArrayCompr):
            out = []
            for env2 in self.eval_body(mod, term.body, env):
                v = self.eval_ground(mod, term.term, env2)
                if v is not UNDEFINED:
                    out.append(v)
            yield out, env
            return
        if isinstance(term, ast.SetCompr):
            out = RegoSet()
            for env2 in self.eval_body(mod, term.body, env):
                v = self.eval_ground(mod, term.term, env2)
                if v is not UNDEFINED:
                    out.add(v)
            yield out, env
            return
        if isinstance(term, ast.ObjectCompr):
            outd: dict = {}
            for env2 in self.eval_body(mod, term.body, env):
                k = self.eval_ground(mod, term.key, env2)
                v = self.eval_ground(mod, term.value, env2)
                if k is UNDEFINED or v is UNDEFINED:
                    continue
                fk = freeze(k)
                if fk in outd and freeze(outd[fk][1]) != freeze(v):
                    raise ConflictError("object comprehension key conflict")
                outd[fk] = (k, v)
            yield {k: v for k, v in outd.values()}, env
            return
        raise RegoError(f"cannot evaluate {term!r}")

    def _eval_var(self, mod, term: ast.Var, env: dict):
        name = term.name
        if name in env:
            yield env[name], env
            return
        if name == "input":
            yield self.input, env
            return
        if name == "data":
            yield _DataPath(()), env
            return
        if name in mod.imports:
            path = mod.imports[name]
            if path[0] == "data":
                yield from self._resolve_data_path(mod, path[1:], env)
                return
            if path[0] == "input":
                v = self._nav_plain(self.input, path[1:])
                if v is not UNDEFINED:
                    yield v, env
                return
        rule = mod.rules.get(name)
        if rule is not None:
            v = self.rule_value(mod, rule)
            if v is not UNDEFINED:
                yield v, env
            return
        # unbound variable as a bare term
        raise UnsafeVarError(f"var {name} is unsafe (unbound at use)")

    def _resolve_data_path(self, mod, path: tuple, env):
        cur: Any = _DataPath(())
        for p in path:
            nxt = list(self._ref_step(mod, cur, p, None, env))
            if not nxt:
                return
            cur = nxt[0][0]
        yield cur, env

    def _nav_plain(self, doc, path):
        cur = doc
        for p in path:
            if isinstance(cur, dict) and p in cur:
                cur = cur[p]
            else:
                return UNDEFINED
        return cur

    def _eval_ref(self, mod, term: ast.Ref, env: dict):
        def walk(cur, args, env):
            if not args:
                yield cur, env
                return
            arg = args[0]
            # unbound variable → enumerate
            if isinstance(arg, ast.Var) and arg.name not in env and not (
                arg.name in ("input", "data")
                or arg.name in mod.imports
                or arg.name in mod.rules
            ):
                for k, v in self._enumerate_node(mod, cur):
                    env2 = dict(env)
                    env2[arg.name] = k
                    yield from walk(v, args[1:], env2)
                return
            for key, env2 in self.eval_term(mod, arg, env):
                for nxt, env3 in self._ref_step(mod, cur, key, arg, env2):
                    yield from walk(nxt, args[1:], env3)

        for base, env1 in self.eval_term(mod, term.head, env):
            yield from walk(base, list(term.args), env1)

    def _enumerate_node(self, mod, cur):
        """(key, value) pairs of a node for unbound-var enumeration."""
        if isinstance(cur, _DataPath):
            cur = self._materialize_data(mod, cur)
        if isinstance(cur, _VirtualDoc):
            vmod = cur.mod
            cur = {
                rname: cur.resolve(self, rname)
                for rname, r in vmod.rules.items()
                if r.kind != "function"
            }
        if isinstance(cur, dict):
            yield from cur.items()
        elif isinstance(cur, (list, tuple)):
            yield from enumerate(cur)
        elif isinstance(cur, RegoSet):
            for v in cur:
                yield v, v
        # scalars: nothing to enumerate

    def _ref_step(self, mod, cur, key, arg_term, env):
        """Index ``cur`` with ground ``key``."""
        if isinstance(cur, _DataPath):
            resolved = self._data_child(mod, cur, key)
            if resolved is not UNDEFINED:
                yield resolved, env
            return
        if isinstance(cur, _VirtualDoc):
            if isinstance(key, str):
                rule = cur.mod.rules.get(key)
                if rule is not None:
                    if rule.kind == "function":
                        return
                    v = self.rule_value(cur.mod, rule)
                    if v is not UNDEFINED:
                        yield v, env
            return
        if isinstance(cur, dict):
            if isinstance(key, (str, int, float, bool)) or key is None:
                if key in cur:
                    yield cur[key], env
            return
        if isinstance(cur, (list, tuple)):
            if isinstance(key, (int, float)) and not isinstance(key, bool):
                i = int(key)
                if i == key and 0 <= i < len(cur):
                    yield cur[i], env
            return
        if isinstance(cur, RegoSet):
            if key in cur:
                yield key, env
            return
        # scalar: no children

    # --- data document ------------------------------------------------
    def _data_child(self, mod, dp: _DataPath, key) -> Any:
        path = dp.path + (key,)
        if not isinstance(key, str):
            base = self._nav_data_base(dp.path)
            if isinstance(base, (dict, list, tuple)):
                for k, v in self._enumerate_node(mod, base):
                    if freeze(k) == freeze(key):
                        return v
            return UNDEFINED
        target_mod = self.modules.by_pkg.get(path)
        if target_mod is not None:
            return _VirtualDoc(target_mod)
        # path may still lead into a package (deeper) or into base data
        if self.modules.packages_under(path):
            return _DataPath(path)
        # walked *into* a module? e.g. data.pkg.rule
        for plen in range(len(path) - 1, 0, -1):
            pmod = self.modules.by_pkg.get(path[:plen])
            if pmod is not None:
                return self._nav_virtual(pmod, path[plen:])
        base = self._nav_data_base(path)
        return base

    def _materialize_data(self, mod, dp: _DataPath):
        out: dict = {}
        base = self._nav_data_base(dp.path)
        if isinstance(base, dict):
            out.update(base)
        for pkg in self.modules.packages_under(dp.path):
            child = pkg[len(dp.path)]
            out.setdefault(child, _DataPath(dp.path + (child,)))
        exact = self.modules.by_pkg.get(dp.path)
        if exact is not None:
            vd = _VirtualDoc(exact)
            for rname in exact.rules:
                out.setdefault(rname, vd.resolve(self, rname))
        return {
            k: (self._materialize_data(mod, v) if isinstance(v, _DataPath) else v)
            for k, v in out.items()
        }

    def _nav_data_base(self, path):
        cur = self.data
        for p in path:
            if isinstance(cur, dict) and p in cur:
                cur = cur[p]
            else:
                return UNDEFINED
        return cur

    def _nav_virtual(self, pmod: ast.Module, path):
        rule = pmod.rules.get(path[0])
        if rule is None:
            return UNDEFINED
        val = self.rule_value(pmod, rule)
        return self._nav_plain(val, path[1:]) if len(path) > 1 else val

    # --- calls ---------------------------------------------------------
    def _eval_call(self, mod, term: ast.Call, env: dict):
        # `walk` is a relation builtin: enumerate [path, value] pairs
        if term.op == "walk":
            yield from self._eval_walk(mod, term, env)
            return
        # `print` is a debugging statement (OPA compiler rewrite
        # semantics): it ALWAYS succeeds and an undefined argument prints
        # as `<undefined>` instead of making the enclosing body undefined
        # — so it cannot be routed through the strict arg-evaluation
        # below.  Output goes to the builtins print hook (gator verify).
        if term.op == "print" and "print" not in mod.rules \
                and self._resolve_function(mod, "print")[0] is None:
            from gatekeeper_tpu_torch.lang.rego.builtins import (UNDEFINED as _UD,
                                                           print_message)

            vals = []
            for at in term.args:
                got = next(self.eval_term(mod, at, env), None)
                vals.append(_UD if got is None else got[0])
            print_message(vals)
            yield True, env
            return
        # resolve user-defined functions first (local, then data.*)
        fn_rule, fn_mod = self._resolve_function(mod, term.op)
        for args, env2 in self._eval_args(mod, term.args, env):
            if fn_rule is not None:
                v = self.call_function(fn_mod, fn_rule, args)
            else:
                impl = REGISTRY.get(term.op)
                if impl is None:
                    raise RegoError(f"unknown function {term.op}")
                v = impl(*args)
            if v is not UNDEFINED:
                yield v, env2

    def _resolve_function(self, mod, op: str):
        parts = tuple(op.split("."))
        rule = mod.rules.get(op)
        if rule is not None and rule.kind == "function":
            return rule, mod
        # imported alias: first segment may be an import
        if parts[0] in mod.imports:
            target = mod.imports[parts[0]]
            if target[0] == "data":
                full = target[1:] + parts[1:]
                return self._find_fn(full)
        if parts[0] == "data":
            return self._find_fn(parts[1:])
        return None, None

    def _find_fn(self, full: tuple):
        for plen in range(len(full) - 1, 0, -1):
            pmod = self.modules.by_pkg.get(full[:plen])
            if pmod is not None and len(full) == plen + 1:
                rule = pmod.rules.get(full[plen])
                if rule is not None and rule.kind == "function":
                    return rule, pmod
        return None, None

    def _eval_args(self, mod, arg_terms, env) -> Iterator[tuple[list, dict]]:
        def rec(i, acc, env):
            if i == len(arg_terms):
                yield list(acc), env
                return
            for v, env2 in self.eval_term(mod, arg_terms[i], env):
                yield from rec(i + 1, acc + [v], env2)

        yield from rec(0, [], env)

    def _eval_walk(self, mod, term: ast.Call, env: dict):
        if len(term.args) != 1:
            raise RegoError("walk/1 only supported as a term")
        for doc, env2 in self.eval_term(mod, term.args[0], env):
            for path, val in _walk_pairs(doc, []):
                yield [path, val], env2

    def _eval_seq(self, mod, items, env, ctor):
        def rec(i, acc, env):
            if i == len(items):
                yield ctor(acc), env
                return
            for v, env2 in self.eval_term(mod, items[i], env):
                yield from rec(i + 1, acc + [v], env2)

        yield from rec(0, [], env)

    def _eval_object(self, mod, term: ast.ObjectTerm, env):
        pairs = term.pairs

        def rec(i, acc, env):
            if i == len(pairs):
                yield dict(acc), env
                return
            kterm, vterm = pairs[i]
            for k, env2 in self.eval_term(mod, kterm, env):
                for v, env3 in self.eval_term(mod, vterm, env2):
                    kk = k if isinstance(k, (str, int, float, bool)) or k is None else _freeze_key(k)
                    yield from rec(i + 1, acc + [(kk, v)], env3)

        yield from rec(0, [], env)

    # ------------------------------------------------------------------
    # unification
    # ------------------------------------------------------------------
    def unify(self, mod, lhs, rhs, env) -> Iterator[dict]:
        """Unify two terms (either side may contain unbound vars)."""
        lvar = self._unbound_var(mod, lhs, env)
        rvar = self._unbound_var(mod, rhs, env)
        if lvar and rvar:
            raise UnsafeVarError(f"cannot unify two unbound vars {lvar}/{rvar}")
        if rvar and not lvar:
            # ground LHS, unbound RHS: bind the RHS pattern
            for v, env2 in self.eval_term(mod, lhs, env):
                yield from self.unify_value(mod, rhs, v, env2)
            return
        for v, env2 in self.eval_term(mod, rhs, env):
            yield from self.unify_value(mod, lhs, v, env2)

    def _unbound_var(self, mod, term, env):
        if isinstance(term, ast.Var) and term.name not in env and (
            term.name not in ("input", "data")
            and term.name not in mod.imports
            and term.name not in mod.rules
        ):
            return term.name
        return None

    def unify_value(self, mod, pattern, value, env) -> Iterator[dict]:
        """Unify a pattern term against a concrete value."""
        if isinstance(pattern, ast.Var):
            name = pattern.name
            if name.startswith("$w"):  # wildcard always matches, no binding
                yield env
                return
            if name in env:
                if freeze(env[name]) == freeze(value):
                    yield env
                return
            if name in ("input", "data") or name in mod.imports or name in mod.rules:
                # bound to a document — compare
                cur = self.eval_ground(mod, pattern, env)
                if freeze(cur) == freeze(value):
                    yield env
                return
            env2 = dict(env)
            env2[name] = value
            yield env2
            return
        if isinstance(pattern, ast.ArrayTerm):
            if not isinstance(value, (list, tuple)) or len(pattern.items) != len(value):
                return
            def rec(i, env):
                if i == len(pattern.items):
                    yield env
                    return
                for env2 in self.unify_value(mod, pattern.items[i], value[i], env):
                    yield from rec(i + 1, env2)
            yield from rec(0, env)
            return
        if isinstance(pattern, ast.ObjectTerm):
            if not isinstance(value, dict):
                return
            def reco(i, env):
                if i == len(pattern.pairs):
                    yield env
                    return
                kterm, vterm = pattern.pairs[i]
                k = self.eval_ground(mod, kterm, env)
                if k is UNDEFINED or k not in value:
                    return
                for env2 in self.unify_value(mod, vterm, value[k], env):
                    yield from reco(i + 1, env2)
            yield from reco(0, env)
            return
        # ground term (or ref/call producing values)
        for v, env2 in self.eval_term(mod, pattern, env):
            if freeze(v) == freeze(value):
                yield env2
        return


class _VirtualDoc:
    """Placeholder for a module used as a document value."""

    __slots__ = ("mod",)

    def __init__(self, mod: ast.Module):
        self.mod = mod

    def resolve(self, ctx: _Ctx, rule_name: str):
        rule = self.mod.rules.get(rule_name)
        if rule is None:
            return UNDEFINED
        return ctx.rule_value(self.mod, rule)


_IN_PROGRESS = object()


def _freeze_key(k):
    # non-scalar object keys are rare; use their frozen form as dict key
    return freeze(k)


def _override_path(doc, path, val):
    if not path:
        return val
    out = dict(doc) if isinstance(doc, dict) else {}
    out[path[0]] = _override_path(out.get(path[0], {}), path[1:], val)
    return out


def _walk_pairs(doc, path):
    yield list(path), doc
    if isinstance(doc, dict):
        for k, v in doc.items():
            yield from _walk_pairs(v, path + [k])
    elif isinstance(doc, (list, tuple)):
        for i, v in enumerate(doc):
            yield from _walk_pairs(v, path + [i])
    elif isinstance(doc, RegoSet):
        for v in doc:
            yield from _walk_pairs(v, path + [v])
