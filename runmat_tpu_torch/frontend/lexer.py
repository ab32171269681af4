"""Copy of runmat_tpu/frontend/lexer.py in the PyTorch port.

MATLAB tokenizer.

Reference parity: runmat-lexer (crates/runmat-lexer/src/{lib,scan,callbacks}.rs) —
a logos-based tokenizer with context callbacks for the transpose-vs-char-literal
ambiguity. This is a hand-written scanner (Python host layer; the lexer is not a
perf hot path — SURVEY.md §2.1 marks it non-native) producing spanned tokens with
a `ws_before` flag the parser uses for matrix-literal column splitting.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..errors import MatError

KEYWORDS = {
    "if", "elseif", "else", "end", "for", "while", "function", "return",
    "break", "continue", "switch", "case", "otherwise", "try", "catch",
    "global", "persistent", "parfor", "spmd", "classdef",
    # properties/methods/events/enumeration/arguments are CONTEXTUAL keywords
    # (valid function/variable names outside classdef/function blocks)
}

# multi-char operators, longest first
_OPS3 = ("...",)
_OPS2 = (".*", "./", ".\\", ".^", ".'", "==", "~=", "<=", ">=", "&&", "||")
_OPS1 = "+-*/\\^'=<>&|~@:,;()[]{}.?!"


@dataclass(frozen=True)
class Token:
    kind: str      # NUM IMAG IDENT KW STR DQSTR OP NEWLINE EOF
    text: str
    line: int
    col: int
    ws_before: bool

    def is_op(self, *ops: str) -> bool:
        return self.kind == "OP" and self.text in ops

    def is_kw(self, *kws: str) -> bool:
        return self.kind == "KW" and self.text in kws

    def __repr__(self):  # pragma: no cover
        return f"{self.kind}({self.text!r})"


def _is_ident_start(c: str) -> bool:
    return c.isalpha() or c == "_"


def _is_ident_char(c: str) -> bool:
    return c.isalnum() or c == "_"


class Lexer:
    def __init__(self, src: str):
        self.src = src
        self.n = len(src)
        self.i = 0
        self.line = 1
        self.col = 1
        self.tokens: list[Token] = []
        self._ws = False

    # -- helpers -------------------------------------------------------------

    def _peek(self, k: int = 0) -> str:
        j = self.i + k
        return self.src[j] if j < self.n else ""

    def _advance(self, k: int = 1) -> None:
        for _ in range(k):
            if self.i < self.n:
                if self.src[self.i] == "\n":
                    self.line += 1
                    self.col = 1
                else:
                    self.col += 1
                self.i += 1

    def _emit(self, kind: str, text: str, line: int, col: int) -> None:
        self.tokens.append(Token(kind, text, line, col, self._ws))
        self._ws = False

    def _prev_allows_transpose(self) -> bool:
        """`'` directly after these tokens is transpose, otherwise a char literal."""
        if self._ws:
            return False  # `x '` starts a char literal in MATLAB expressions... except
            # MATLAB actually treats `a '` inside brackets as string; conservative: ws -> string
        for t in reversed(self.tokens):
            if t.kind == "NEWLINE":
                return False
            if t.kind in ("NUM", "IMAG", "IDENT"):
                return True
            if t.kind == "KW" and t.text == "end":
                return True
            if t.kind == "OP" and t.text in (")", "]", "}", "'", ".'"):
                return True
            return False
        return False

    # -- scanning --------------------------------------------------------------

    def tokenize(self) -> list[Token]:
        while self.i < self.n:
            c = self._peek()
            line, col = self.line, self.col

            if c in " \t\r":
                self._advance()
                self._ws = True
                continue

            if c == "\n":
                self._advance()
                self._emit("NEWLINE", "\n", line, col)
                continue

            if c == "%":
                # block comment: %{ alone on a line ... %}
                if self._peek(1) == "{" and self._line_is_only_block_marker("{"):
                    self._skip_block_comment()
                    continue
                while self.i < self.n and self._peek() != "\n":
                    self._advance()
                continue

            if c == "." and self._peek(1) == "." and self._peek(2) == ".":
                # line continuation: skip to end of line *and* the newline
                while self.i < self.n and self._peek() != "\n":
                    self._advance()
                if self.i < self.n:
                    self._advance()
                self._ws = True
                continue

            if c.isdigit() or (c == "." and self._peek(1).isdigit()):
                self._scan_number(line, col)
                continue

            if _is_ident_start(c):
                j = self.i
                while j < self.n and _is_ident_char(self.src[j]):
                    j += 1
                word = self.src[self.i:j]
                self._advance(j - self.i)
                if word in KEYWORDS:
                    self._emit("KW", word, line, col)
                else:
                    self._emit("IDENT", word, line, col)
                continue

            if c == "'":
                if self._prev_allows_transpose():
                    self._advance()
                    self._emit("OP", "'", line, col)
                else:
                    self._scan_quoted("'", "STR", line, col)
                continue

            if c == '"':
                self._scan_quoted('"', "DQSTR", line, col)
                continue

            # operators
            three = self.src[self.i:self.i + 3]
            two = self.src[self.i:self.i + 2]
            if three in _OPS3:
                self._advance(3)
                self._emit("OP", three, line, col)
                continue
            if two in _OPS2:
                self._advance(2)
                self._emit("OP", two, line, col)
                continue
            if c in _OPS1:
                self._advance()
                self._emit("OP", c, line, col)
                continue

            raise MatError("MATLAB:lexer:unexpectedCharacter",
                           f"Unexpected character '{c}' at line {line}, column {col}.")

        self.tokens.append(Token("EOF", "", self.line, self.col, self._ws))
        return self.tokens

    def _line_is_only_block_marker(self, brace: str) -> bool:
        # scan backward to line start: only whitespace allowed before %{ / %}
        j = self.i - 1
        while j >= 0 and self.src[j] != "\n":
            if self.src[j] not in " \t\r":
                return False
            j -= 1
        # scan forward after marker: only whitespace to EOL
        j = self.i + 2
        while j < self.n and self.src[j] != "\n":
            if self.src[j] not in " \t\r":
                return False
            j += 1
        return True

    def _skip_block_comment(self) -> None:
        depth = 0
        while self.i < self.n:
            if self._peek() == "%" and self._peek(1) == "{" and self._line_is_only_block_marker("{"):
                depth += 1
                self._advance(2)
            elif self._peek() == "%" and self._peek(1) == "}" and self._line_is_only_block_marker("}"):
                depth -= 1
                self._advance(2)
                if depth == 0:
                    # consume to EOL
                    while self.i < self.n and self._peek() != "\n":
                        self._advance()
                    return
            else:
                self._advance()
        raise MatError("MATLAB:lexer:unterminatedComment", "Unterminated block comment.")

    def _scan_number(self, line: int, col: int) -> None:
        j = self.i
        src, n = self.src, self.n
        if src[j] == "0" and j + 1 < n and src[j + 1] in "xXbB":
            base_char = src[j + 1].lower()
            j += 2
            digits = "0123456789abcdefABCDEF" if base_char == "x" else "01"
            while j < n and src[j] in digits:
                j += 1
            text = src[self.i:j]
            self._advance(j - self.i)
            self._emit("NUM", text, line, col)
            return
        while j < n and src[j].isdigit():
            j += 1
        if j < n and src[j] == ".":
            # not `.*` etc. and not field access after number (1.x invalid anyway)
            if j + 1 < n and src[j + 1] in "*/\\^'":
                pass  # `1.*x` — the dot belongs to the operator
            else:
                j += 1
                while j < n and src[j].isdigit():
                    j += 1
        if j < n and src[j] in "eE":
            k = j + 1
            if k < n and src[k] in "+-":
                k += 1
            if k < n and src[k].isdigit():
                j = k
                while j < n and src[j].isdigit():
                    j += 1
        kind = "NUM"
        if j < n and src[j] in "ij":
            # imaginary suffix, only if not followed by ident char
            if j + 1 >= n or not _is_ident_char(src[j + 1]):
                j += 1
                kind = "IMAG"
        text = src[self.i:j]
        self._advance(j - self.i)
        self._emit(kind, text, line, col)

    def _scan_quoted(self, q: str, kind: str, line: int, col: int) -> None:
        self._advance()  # opening quote
        out = []
        while True:
            if self.i >= self.n or self._peek() == "\n":
                raise MatError("MATLAB:lexer:unterminatedString",
                               f"Unterminated {'char' if q == chr(39) else 'string'} literal at line {line}.")
            c = self._peek()
            if c == q:
                if self._peek(1) == q:  # escaped quote
                    out.append(q)
                    self._advance(2)
                    continue
                self._advance()
                break
            out.append(c)
            self._advance()
        self._emit(kind, "".join(out), line, col)


def tokenize(src: str) -> list[Token]:
    return Lexer(src).tokenize()
