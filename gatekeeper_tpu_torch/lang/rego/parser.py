"""Recursive-descent parser for the Rego subset.

Supports the v0 syntax used across gatekeeper policy libraries (partial set
rules, multi-clause functions, comprehensions, ``some``/``not``/``else``,
``with`` modifiers) plus the v1 sugar ``if`` / ``contains`` / ``in`` /
``every`` so modern library copies parse too.
"""

from __future__ import annotations

from typing import Optional

from gatekeeper_tpu_torch.lang.rego import ast
from gatekeeper_tpu_torch.lang.rego.lexer import Token, tokenize


class ParseError(SyntaxError):
    pass


# ops at each precedence level (loosest first)
_CMP_OPS = {"==": "equal", "!=": "neq", "<": "lt", "<=": "lte", ">": "gt",
            ">=": "gte"}
_ADD_OPS = {"+": "plus", "-": "minus", "|": "or", "&": "and"}
_MUL_OPS = {"*": "mul", "/": "div", "%": "rem"}


class Parser:
    def __init__(self, src: str):
        self.toks = tokenize(src)
        self.i = 0
        self._wildcard = 0

    # --- token helpers ---------------------------------------------------
    def peek(self, skip_nl: bool = False) -> Token:
        j = self.i
        if skip_nl:
            while self.toks[j].kind == "newline":
                j += 1
        return self.toks[j]

    def next(self, skip_nl: bool = False) -> Token:
        if skip_nl:
            self.skip_newlines()
        t = self.toks[self.i]
        if t.kind != "eof":
            self.i += 1
        return t

    def skip_newlines(self):
        while self.toks[self.i].kind == "newline":
            self.i += 1

    def expect(self, kind: str, value: Optional[str] = None,
               skip_nl: bool = False) -> Token:
        t = self.next(skip_nl=skip_nl)
        if t.kind != kind or (value is not None and t.value != value):
            got = "end of file" if t.kind == "eof" else repr(t.value)
            raise ParseError(
                f"expected {value or kind}, got {got} at line {t.line}"
            )
        return t

    def at(self, kind: str, value: Optional[str] = None,
           skip_nl: bool = False) -> bool:
        t = self.peek(skip_nl=skip_nl)
        return t.kind == kind and (value is None or t.value == value)

    def eat(self, kind: str, value: Optional[str] = None,
            skip_nl: bool = False) -> bool:
        if self.at(kind, value, skip_nl=skip_nl):
            self.next(skip_nl=skip_nl)
            return True
        return False

    def fresh_wildcard(self) -> ast.Var:
        self._wildcard += 1
        return ast.Var(f"$w{self._wildcard}")

    # --- module ----------------------------------------------------------
    def parse_module(self) -> ast.Module:
        self.skip_newlines()
        self.expect("keyword", "package")
        pkg = [self.expect("ident").value]
        while self.eat("op", "."):
            pkg.append(self.next().value)
        mod = ast.Module(package=tuple(pkg))
        self.skip_newlines()
        while self.at("keyword", "import", skip_nl=True):
            self.next(skip_nl=True)
            path = [self.next().value]
            while self.eat("op", "."):
                path.append(self.next().value)
            alias = path[-1]
            if self.eat("keyword", "as"):
                alias = self.expect("ident").value
            # `import future.keywords...` / `import rego.v1` are no-ops here
            if path[0] not in ("future", "rego"):
                mod.imports[alias] = tuple(path)
            self.skip_newlines()
        while not self.at("eof", skip_nl=True):
            self.parse_rule(mod)
        return mod

    # --- rules -----------------------------------------------------------
    def parse_rule(self, mod: ast.Module):
        self.skip_newlines()
        is_default = self.eat("keyword", "default")
        name_tok = self.next()
        if name_tok.kind not in ("ident", "keyword"):
            raise ParseError(f"bad rule head at line {name_tok.line}")
        name = name_tok.value

        if is_default:
            self.expect_any_assign()
            value = self.parse_term()
            self._end_statement()
            rule = mod.rules.setdefault(name, ast.Rule(name, "complete"))
            rule.default = value
            return

        kind = "complete"
        key = value = args = None

        if self.at("op", "("):  # function
            self.next()
            kind = "function"
            args = tuple(self.parse_term_list(")"))
        elif self.at("op", "["):  # partial set/object: name[key]
            self.next()
            self.skip_newlines()
            key = self.parse_term()
            self.expect("op", "]", skip_nl=True)
            kind = "set"  # may become "object" if '= value' follows
        elif self.at("keyword", "contains"):  # v1: name contains term if body
            self.next()
            key = self.parse_term()
            kind = "set"

        if self.at("op", "=") or self.at("op", ":="):
            self.next()
            value = self.parse_term()
            if kind == "set":
                kind = "object"

        self.eat("keyword", "if")  # v1 sugar
        body: tuple = ()
        if self.at("op", "{"):
            self.next()
            body = tuple(self.parse_body("}"))
            self.expect("op", "}", skip_nl=True)
        elif value is None and kind != "set":
            raise ParseError(f"rule {name} at line {name_tok.line}: no body/value")

        clause = ast.Clause(body=body, key=key, value=value, args=args)
        # else chain
        cur = clause
        while self.at("keyword", "else", skip_nl=True):
            self.next(skip_nl=True)
            evalue = None
            if self.at("op", "=") or self.at("op", ":="):
                self.next()
                evalue = self.parse_term()
            self.eat("keyword", "if")
            ebody: tuple = ()
            if self.at("op", "{", skip_nl=False):
                self.next()
                ebody = tuple(self.parse_body("}"))
                self.expect("op", "}", skip_nl=True)
            cur.els = ast.Clause(body=ebody, key=None, value=evalue, args=args)
            cur = cur.els
        self._end_statement()

        rule = mod.rules.setdefault(name, ast.Rule(name, kind))
        if rule.kind != kind:
            raise ParseError(f"rule {name}: conflicting kinds {rule.kind}/{kind}")
        rule.clauses.append(clause)

    def expect_any_assign(self):
        if not (self.eat("op", "=") or self.eat("op", ":=")):
            t = self.peek()
            raise ParseError(f"expected = at line {t.line}")

    def _end_statement(self):
        if not (self.at("newline") or self.at("eof") or self.at("op", "}")):
            t = self.peek()
            raise ParseError(f"unexpected {t.value!r} at line {t.line}")

    # --- bodies ----------------------------------------------------------
    def parse_body(self, terminator: str) -> list:
        stmts = []
        while True:
            self.skip_newlines()
            while self.eat("op", ";"):
                self.skip_newlines()
            if self.at("op", terminator) or self.at("eof"):
                return stmts
            stmts.append(self.parse_statement())
            # statements separated by newline or ';'
            if not (self.at("newline") or self.at("op", ";")
                    or self.at("op", terminator) or self.at("eof")):
                t = self.peek()
                raise ParseError(
                    f"expected statement separator, got {t.value!r} line {t.line}"
                )

    def parse_statement(self) -> ast.Node:
        if self.at("keyword", "some"):
            return self.parse_some()
        if self.at("keyword", "every"):
            return self.parse_every()
        if self.at("keyword", "not"):
            self.next()
            term = self.parse_expr()
            return self.finish_stmt(ast.ExprStmt(term, negated=True))
        term = self.parse_expr()
        if self.at("op", ":="):
            self.next()
            rhs = self.parse_expr()
            return self.finish_stmt(ast.AssignStmt(term, rhs))
        if self.at("op", "="):
            self.next()
            rhs = self.parse_expr()
            return self.finish_stmt(ast.UnifyStmt(term, rhs))
        return self.finish_stmt(ast.ExprStmt(term))

    def finish_stmt(self, stmt: ast.Node) -> ast.Node:
        withs = []
        while self.at("keyword", "with"):
            self.next()
            target = self.parse_ref_path()
            self.expect("keyword", "as")
            val = self.parse_expr()
            withs.append((target, val))
        if withs:
            return WithWrapped(stmt, tuple(withs))
        return stmt

    def parse_ref_path(self) -> tuple:
        parts = [self.next().value]
        while self.eat("op", "."):
            parts.append(self.next().value)
        return tuple(parts)

    def parse_some(self) -> ast.Node:
        self.expect("keyword", "some")
        first = self.parse_expr_no_in()
        names = [first]
        second = None
        if self.eat("op", ","):
            second = self.parse_expr_no_in()
            names.append(second)
        if self.eat("keyword", "in"):
            coll = self.parse_expr()
            if second is not None:
                return ast.SomeIn(key=first, value=second, collection=coll)
            return ast.SomeIn(key=None, value=first, collection=coll)
        out = []
        for nm in names:
            if not isinstance(nm, ast.Var):
                raise ParseError("some declaration expects variables")
            out.append(nm.name)
        return ast.SomeDecl(tuple(out))

    def parse_every(self) -> ast.Node:
        self.expect("keyword", "every")
        v1 = self.expect("ident").value
        k = None
        if self.eat("op", ","):
            k = v1
            v1 = self.expect("ident").value
        self.expect("keyword", "in")
        domain = self.parse_expr_no_in()
        self.expect("op", "{", skip_nl=True)
        body = tuple(self.parse_body("}"))
        self.expect("op", "}", skip_nl=True)
        return ast.EveryStmt(key=k, value=v1, domain=domain, body=body)

    # --- expressions ------------------------------------------------------
    def parse_expr(self, allow_in: bool = True, no_union: bool = False) -> ast.Node:
        lhs = self.parse_add(no_union=no_union)
        t = self.peek()
        if t.kind == "op" and t.value in _CMP_OPS:
            self.next()
            self.skip_newlines()
            rhs = self.parse_add()
            return ast.Call(_CMP_OPS[t.value], (lhs, rhs))
        if allow_in and self.at("keyword", "in"):
            self.next()
            self.skip_newlines()
            rhs = self.parse_add()
            return ast.Call("internal.member_2", (lhs, rhs))
        return lhs

    def parse_expr_no_in(self) -> ast.Node:
        return self.parse_expr(allow_in=False)

    def parse_add(self, no_union: bool = False) -> ast.Node:
        lhs = self.parse_mul()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in _ADD_OPS:
                # a bare '|' right after the first term of a bracketed
                # expression is a comprehension separator, not set-union
                if t.value == "|" and no_union:
                    return lhs
                self.next()
                self.skip_newlines()
                rhs = self.parse_mul()
                lhs = ast.Call(_ADD_OPS[t.value], (lhs, rhs))
            else:
                return lhs

    def parse_mul(self) -> ast.Node:
        lhs = self.parse_unary()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in _MUL_OPS:
                self.next()
                self.skip_newlines()
                rhs = self.parse_unary()
                lhs = ast.Call(_MUL_OPS[t.value], (lhs, rhs))
            else:
                return lhs

    def parse_unary(self) -> ast.Node:
        if self.at("op", "-"):
            self.next()
            operand = self.parse_unary()
            if isinstance(operand, ast.Scalar) and isinstance(
                operand.value, (int, float)
            ):
                return ast.Scalar(-operand.value)
            return ast.Call("minus", (ast.Scalar(0), operand))
        return self.parse_postfix()

    def parse_postfix(self) -> ast.Node:
        term = self.parse_primary()
        args: list = []
        while True:
            if self.at("op", "."):
                self.next()
                t = self.next()
                if t.kind not in ("ident", "keyword"):
                    raise ParseError(f"bad ref at line {t.line}")
                args.append(ast.Scalar(t.value))
            elif self.at("op", "["):
                self.next()
                self.skip_newlines()
                idx = self.parse_expr()
                self.expect("op", "]", skip_nl=True)
                args.append(idx)
            elif self.at("op", "("):
                # call: target must be a constant dotted path
                self.next()
                call_args = self.parse_term_list(")")
                op = self._ref_to_call_name(term, args)
                term = ast.Call(op, tuple(call_args))
                args = []
            else:
                break
        if args:
            return ast.Ref(head=term, args=tuple(args))
        return term

    def _ref_to_call_name(self, head: ast.Node, args: list) -> str:
        parts = []
        if isinstance(head, ast.Var):
            parts.append(head.name)
        else:
            raise ParseError("calls must target a named function")
        for a in args:
            if isinstance(a, ast.Scalar) and isinstance(a.value, str):
                parts.append(a.value)
            else:
                raise ParseError("calls must target a constant ref")
        return ".".join(parts)

    def parse_primary(self) -> ast.Node:
        t = self.peek()
        if t.kind == "number":
            self.next()
            v = float(t.value) if any(c in t.value for c in ".eE") else int(t.value)
            return ast.Scalar(v)
        if t.kind == "string":
            self.next()
            return ast.Scalar(t.value)
        if t.kind == "keyword" and t.value in ("true", "false", "null"):
            self.next()
            return ast.Scalar({"true": True, "false": False, "null": None}[t.value])
        if t.kind == "ident":
            self.next()
            if t.value == "_":
                return self.fresh_wildcard()
            return ast.Var(t.value)
        if t.kind == "keyword" and t.value == "contains":
            # `contains` is v1 rule-head sugar but also an OPA builtin; in
            # term position it is always the builtin reference
            self.next()
            return ast.Var("contains")
        if t.kind == "op" and t.value == "(":
            self.next()
            self.skip_newlines()
            inner = self.parse_expr()
            self.expect("op", ")", skip_nl=True)
            return inner
        if t.kind == "op" and t.value == "[":
            self.next()
            self.skip_newlines()
            if self.at("op", "]", skip_nl=True):
                self.next(skip_nl=True)
                return ast.ArrayTerm(())
            first = self.parse_expr(no_union=True)
            if self.at("op", "|", skip_nl=True) and self._compr_bar():
                self.next(skip_nl=True)
                body = tuple(self.parse_body("]"))
                self.expect("op", "]", skip_nl=True)
                return ast.ArrayCompr(first, body)
            items = [first]
            while self.eat("op", ",", skip_nl=True):
                if self.at("op", "]", skip_nl=True):
                    break
                self.skip_newlines()
                items.append(self.parse_expr())
            self.expect("op", "]", skip_nl=True)
            return ast.ArrayTerm(tuple(items))
        if t.kind == "op" and t.value == "{":
            return self.parse_brace()
        got = "end of file" if t.kind == "eof" else repr(t.value)
        raise ParseError(f"unexpected {got} at line {t.line}")

    def _compr_bar(self) -> bool:
        """True when the upcoming '|' starts a comprehension body (vs set-union
        inside an element expression).  parse_expr already consumed unions, so a
        bare '|' here is always a comprehension separator."""
        return True

    def parse_brace(self) -> ast.Node:
        self.expect("op", "{")
        self.skip_newlines()
        if self.at("op", "}", skip_nl=True):
            self.next(skip_nl=True)
            return ast.ObjectTerm(())  # {} is an empty object
        first = self.parse_expr(no_union=True)
        if self.at("op", ":", skip_nl=True):
            self.next(skip_nl=True)
            self.skip_newlines()
            val = self.parse_expr(no_union=True)
            if self.at("op", "|", skip_nl=True):
                self.next(skip_nl=True)
                body = tuple(self.parse_body("}"))
                self.expect("op", "}", skip_nl=True)
                return ast.ObjectCompr(first, val, body)
            pairs = [(first, val)]
            while self.eat("op", ",", skip_nl=True):
                if self.at("op", "}", skip_nl=True):
                    break
                self.skip_newlines()
                k = self.parse_expr()
                self.expect("op", ":", skip_nl=True)
                self.skip_newlines()
                v = self.parse_expr()
                pairs.append((k, v))
            self.expect("op", "}", skip_nl=True)
            return ast.ObjectTerm(tuple(pairs))
        if self.at("op", "|", skip_nl=True):
            self.next(skip_nl=True)
            body = tuple(self.parse_body("}"))
            self.expect("op", "}", skip_nl=True)
            return ast.SetCompr(first, body)
        items = [first]
        while self.eat("op", ",", skip_nl=True):
            if self.at("op", "}", skip_nl=True):
                break
            self.skip_newlines()
            items.append(self.parse_expr())
        self.expect("op", "}", skip_nl=True)
        return ast.SetTerm(tuple(items))

    def parse_term(self) -> ast.Node:
        return self.parse_expr()

    def parse_term_list(self, terminator: str) -> list:
        out = []
        self.skip_newlines()
        if self.at("op", terminator, skip_nl=True):
            self.next(skip_nl=True)
            return out
        out.append(self.parse_expr())
        while self.eat("op", ",", skip_nl=True):
            self.skip_newlines()
            out.append(self.parse_expr())
        self.expect("op", terminator, skip_nl=True)
        return out


class WithWrapped(ast.Node):
    """Statement with `with ... as ...` modifiers."""

    __slots__ = ("stmt", "withs")

    def __init__(self, stmt: ast.Node, withs: tuple):
        self.stmt = stmt
        self.withs = withs


def parse_module(src: str) -> ast.Module:
    return Parser(src).parse_module()
