"""Rego lexer."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

KEYWORDS = {
    "package", "import", "default", "not", "some", "as", "with", "else",
    "true", "false", "null", "in", "every", "if", "contains",
}

TWO_CHAR = {":=", "==", "!=", "<=", ">="}
ONE_CHAR = set("=<>+-*/%&|;,.:[](){}")


class LexError(SyntaxError):
    pass


@dataclass(frozen=True)
class Token:
    kind: str  # ident | keyword | number | string | op | newline | eof
    value: str
    line: int
    col: int

    def __repr__(self):
        return f"Token({self.kind},{self.value!r}@{self.line})"


def tokenize(src: str) -> list[Token]:
    toks: list[Token] = []
    i, line, col = 0, 1, 1
    n = len(src)

    def push(kind, value, ln=None, cl=None):
        toks.append(Token(kind, value, ln or line, cl or col))

    while i < n:
        c = src[i]
        if c == "\n":
            push("newline", "\n")
            i += 1
            line += 1
            col = 1
            continue
        if c in " \t\r":
            i += 1
            col += 1
            continue
        if c == "#":
            while i < n and src[i] != "\n":
                i += 1
            continue
        if c == "`":  # raw string
            j = src.find("`", i + 1)
            if j < 0:
                raise LexError(f"unterminated raw string at line {line}")
            push("string", src[i + 1 : j])
            col += j - i + 1
            nl = src.count("\n", i, j)
            if nl:
                line += nl
            i = j + 1
            continue
        if c == '"':
            j = i + 1
            buf = []
            while j < n and src[j] != '"':
                if src[j] == "\\":
                    if j + 1 >= n:
                        raise LexError(f"unterminated escape at line {line}")
                    esc = src[j + 1]
                    if esc == "u":
                        hexs = src[j + 2 : j + 6]
                        if len(hexs) < 4 or any(
                            c not in "0123456789abcdefABCDEF" for c in hexs
                        ):
                            raise LexError(f"bad \\u escape at line {line}")
                        buf.append(chr(int(hexs, 16)))
                        j += 6
                        continue
                    buf.append(
                        {"n": "\n", "t": "\t", "r": "\r", '"': '"', "\\": "\\",
                         "/": "/", "b": "\b", "f": "\f"}.get(esc, "\\" + esc)
                    )
                    j += 2
                else:
                    buf.append(src[j])
                    j += 1
            if j >= n:
                raise LexError(f"unterminated string at line {line}")
            push("string", "".join(buf))
            col += j - i + 1
            i = j + 1
            continue
        if c.isdigit() or (c == "." and i + 1 < n and src[i + 1].isdigit()):
            j = i
            while j < n and (src[j].isdigit() or src[j] in ".eE+-"):
                # stop '+-' unless exponent
                if src[j] in "+-" and src[j - 1] not in "eE":
                    break
                j += 1
            push("number", src[i:j])
            col += j - i
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (src[j].isalnum() or src[j] == "_"):
                j += 1
            word = src[i:j]
            push("keyword" if word in KEYWORDS else "ident", word)
            col += j - i
            i = j
            continue
        if src[i : i + 2] in TWO_CHAR:
            push("op", src[i : i + 2])
            i += 2
            col += 2
            continue
        if c in ONE_CHAR:
            push("op", c)
            i += 1
            col += 1
            continue
        raise LexError(f"unexpected character {c!r} at line {line}:{col}")
    push("eof", "")
    return toks
