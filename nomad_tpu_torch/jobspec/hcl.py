"""HCL tokenizer and parser, the generic half of the jobspec language
(port of nomad_tpu/jobspec/hcl.py; upstream: jobspec2/parse.go:21 over
hashicorp/hcl/v2). It parses the HCL subset job files use: blocks with
string labels, attributes, strings with escapes and ${...}
interpolation (kept verbatim for runtime interpolation unless it is a
resolvable var/local reference or a parse-time function call), numbers,
bools, null, lists, objects, heredocs, the three comment forms, the HCL2
functions of ``FUNCTIONS`` and variable blocks. The output is a generic
tree (Block of Attribute | Block) that parse.py maps onto Job structs.
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Union


class HclError(Exception):
    def __init__(self, msg: str, line: int = 0):
        super().__init__(f"line {line}: {msg}" if line else msg)
        self.line = line


@dataclass
class Attribute:
    name: str
    value: Any
    line: int = 0


@dataclass
class Block:
    type: str
    labels: List[str] = field(default_factory=list)
    body: List[Union["Block", Attribute]] = field(default_factory=list)
    line: int = 0

    # -- conveniences used by the mapper -------------------------------
    def attrs(self) -> Dict[str, Any]:
        return {i.name: i.value for i in self.body
                if isinstance(i, Attribute)}

    def blocks(self, btype: Optional[str] = None) -> List["Block"]:
        out = [i for i in self.body if isinstance(i, Block)]
        if btype is not None:
            out = [b for b in out if b.type == btype]
        return out

    def first(self, btype: str) -> Optional["Block"]:
        bs = self.blocks(btype)
        return bs[0] if bs else None

    def label(self, k: int = 0, default: str = "") -> str:
        return self.labels[k] if k < len(self.labels) else default


# ---------------------------------------------------------------------------
# tokenizer

_TOKEN_RE = re.compile(r"""
    (?P<ws>[ \t\r]+)
  | (?P<comment>\#[^\n]*|//[^\n]*|/\*.*?\*/)
  | (?P<heredoc><<-?(?P<hd_tag>[A-Za-z_][A-Za-z0-9_]*)\n)
  | (?P<string>"(?:\\.|\$\{[^}]*\}|[^"\\])*")
  | (?P<number>-?\d+(?:\.\d+)?(?![A-Za-z_]))
  | (?P<ident>[A-Za-z_][A-Za-z0-9_.\-]*)
  | (?P<punct>[={}\[\],:\n()])
""", re.VERBOSE | re.DOTALL)


@dataclass
class Token:
    kind: str
    value: str
    line: int


def tokenize(src: str) -> List[Token]:
    tokens: List[Token] = []
    pos, line = 0, 1
    n = len(src)
    while pos < n:
        m = _TOKEN_RE.match(src, pos)
        if m is None:
            raise HclError(f"unexpected character {src[pos]!r}", line)
        kind = m.lastgroup or ""
        text = m.group(0)
        if kind == "heredoc":
            tag = m.group("hd_tag")
            line += 1
            end_re = re.compile(rf"^[ \t]*{re.escape(tag)}[ \t]*$",
                                re.MULTILINE)
            em = end_re.search(src, m.end())
            if em is None:
                raise HclError(f"heredoc {tag} unterminated", line)
            content = src[m.end():em.start()]
            tokens.append(Token("string", content, line))
            line += content.count("\n") + 1
            pos = em.end()
            continue
        if kind == "ws":
            pass
        elif kind == "comment":
            line += text.count("\n")
        elif kind == "punct" and text == "\n":
            tokens.append(Token("newline", text, line))
            line += 1
        elif kind == "string":
            tokens.append(Token("string", _unquote(text, line), line))
        else:
            tokens.append(Token(kind, text, line))
        pos = m.end()
    tokens.append(Token("eof", "", line))
    return tokens


def _unquote(text: str, line: int) -> str:
    body = text[1:-1]
    out = []
    i = 0
    while i < len(body):
        c = body[i]
        if c == "\\" and i + 1 < len(body):
            esc = body[i + 1]
            out.append({"n": "\n", "t": "\t", '"': '"', "\\": "\\",
                        "r": "\r"}.get(esc, esc))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


# ---------------------------------------------------------------------------
# parser

def _fn_format(fmt, *args):
    """HCL2 format(): %s/%d/%v/%q/%.Nf via Python's printf."""
    out = str(fmt).replace("%v", "%s").replace("%q", '"%s"')
    return out % tuple(args)


# the HCL2 stdlib subset jobspecs actually use
# (upstream: jobspec2/types.variables.go + hcl2 ext stdlib funcs)
FUNCTIONS: Dict[str, Any] = {
    "upper": lambda s: str(s).upper(),
    "lower": lambda s: str(s).lower(),
    "title": lambda s: str(s).title(),
    "trimspace": lambda s: str(s).strip(),
    "format": _fn_format,
    "join": lambda sep, xs: str(sep).join(str(x) for x in xs),
    "split": lambda sep, s: str(s).split(str(sep)),
    "replace": lambda s, a, b: str(s).replace(str(a), str(b)),
    "substr": lambda s, off, n: str(s)[int(off):int(off) + int(n)],
    "length": lambda x: len(x),
    "concat": lambda *ls: [x for sub in ls for x in sub],
    "contains": lambda xs, v: v in xs,
    "min": lambda *xs: min(xs),
    "max": lambda *xs: max(xs),
    "abs": lambda x: abs(x),
    "ceil": lambda x: math.ceil(float(x)),
    "floor": lambda x: math.floor(float(x)),
    "coalesce": lambda *xs: next((x for x in xs
                                  if x is not None and x != ""), None),
    "tostring": lambda x: str(x),
    "tonumber": lambda x: float(x) if "." in str(x) else int(x),
    "keys": lambda m: sorted(m.keys()),
    "values": lambda m: [m[k] for k in sorted(m.keys())],
    "merge": lambda *ms: {k: v for m in ms for k, v in m.items()},
    "range": lambda *a: list(range(*(int(x) for x in a))),
}

# type-constructor expressions, valid ONLY inside variable blocks
# (variable { type = list(string) }); evaluating them in the general
# expression language would silently turn list()/map() calls elsewhere
# into literal strings instead of a clear unknown-function error
TYPE_FUNCTIONS: Dict[str, Any] = {
    "list": lambda t="": f"list({t})",
    "set": lambda t="": f"set({t})",
    "map": lambda t="": f"map({t})",
}


class Parser:
    def __init__(self, tokens: List[Token],
                 variables: Optional[Dict[str, Any]] = None):
        self.tokens = tokens
        self.i = 0
        self.variables = variables if variables is not None else {}
        # enclosing-block stack: type constructors (list/set/map) only
        # evaluate inside `variable` blocks
        self._block_stack: List[str] = []

    def peek(self) -> Token:
        return self.tokens[self.i]

    def next(self) -> Token:
        t = self.tokens[self.i]
        self.i += 1
        return t

    def skip_newlines(self) -> None:
        while self.peek().kind == "newline":
            self.next()

    def parse_body(self, root: bool = False) -> List[Union[Block, Attribute]]:
        items: List[Union[Block, Attribute]] = []
        while True:
            self.skip_newlines()
            t = self.peek()
            if t.kind == "eof":
                if not root:
                    raise HclError("unexpected EOF in block", t.line)
                return items
            if t.kind == "punct" and t.value == "}":
                if root:
                    raise HclError("unexpected '}'", t.line)
                return items
            if t.kind != "ident":
                raise HclError(f"expected identifier, got {t.value!r}",
                               t.line)
            items.append(self.parse_item())

    def parse_item(self) -> Union[Block, Attribute]:
        name = self.next()
        t = self.peek()
        if t.kind == "punct" and t.value == "=":
            self.next()
            value = self.parse_expr()
            return Attribute(name=name.value, value=value, line=name.line)
        # block: labels then {
        labels: List[str] = []
        while self.peek().kind in ("string", "ident"):
            labels.append(self.next().value)
        t = self.peek()
        if not (t.kind == "punct" and t.value == "{"):
            raise HclError(f"expected '{{' after {name.value}", t.line)
        self.next()
        self._block_stack.append(name.value)
        try:
            body = self.parse_body()
        finally:
            self._block_stack.pop()
        close = self.next()
        if not (close.kind == "punct" and close.value == "}"):
            raise HclError("expected '}'", close.line)
        return Block(type=name.value, labels=labels, body=body,
                     line=name.line)

    def parse_expr(self) -> Any:
        self.skip_newlines()
        t = self.next()
        if t.kind == "string":
            return self._interp(t.value, t.line)
        if t.kind == "number":
            return float(t.value) if "." in t.value else int(t.value)
        if t.kind == "ident":
            if t.value == "true":
                return True
            if t.value == "false":
                return False
            if t.value == "null":
                return None
            nxt = self.peek()
            if nxt.kind == "punct" and nxt.value == "(":
                return self._parse_call(t.value, t.line)
            return self._resolve_ref(t.value, t.line)
        if t.kind == "punct" and t.value == "[":
            return self._parse_list()
        if t.kind == "punct" and t.value == "{":
            return self._parse_object()
        raise HclError(f"unexpected token {t.value!r} in expression",
                       t.line)

    def _parse_list(self) -> List[Any]:
        out = []
        while True:
            self.skip_newlines()
            t = self.peek()
            if t.kind == "punct" and t.value == "]":
                self.next()
                return out
            out.append(self.parse_expr())
            self.skip_newlines()
            if self.peek().kind == "punct" and self.peek().value == ",":
                self.next()

    def _parse_object(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        while True:
            self.skip_newlines()
            t = self.peek()
            if t.kind == "punct" and t.value == "}":
                self.next()
                return out
            key = self.next()
            if key.kind not in ("ident", "string"):
                raise HclError(f"bad object key {key.value!r}", key.line)
            sep = self.next()
            if not (sep.kind == "punct" and sep.value in ("=", ":")):
                raise HclError("expected '=' or ':' in object", sep.line)
            out[key.value] = self.parse_expr()
            self.skip_newlines()
            if self.peek().kind == "punct" and self.peek().value == ",":
                self.next()

    def _parse_call(self, name: str, line: int) -> Any:
        """HCL2 function call (upstream: jobspec2's hcl2 stdlib)."""
        self.next()                                 # consume '('
        args: List[Any] = []
        while True:
            self.skip_newlines()
            t = self.peek()
            if t.kind == "punct" and t.value == ")":
                self.next()
                break
            args.append(self.parse_expr())
            self.skip_newlines()
            if self.peek().kind == "punct" and self.peek().value == ",":
                self.next()
        fn = FUNCTIONS.get(name)
        if fn is None and name in TYPE_FUNCTIONS \
                and "variable" in self._block_stack:
            fn = TYPE_FUNCTIONS[name]
        if fn is None:
            raise HclError(f"unknown function {name!r}", line)
        try:
            return fn(*args)
        except HclError:
            raise
        except Exception as e:  # noqa: BLE001 -- user input
            raise HclError(f"{name}(): {e}", line)

    # -- references & interpolation ------------------------------------
    def _resolve_ref(self, path: str, line: int) -> Any:
        if path.startswith("var."):
            name = path[len("var."):]
            if name in self.variables:
                return self.variables[name]
            raise HclError(f"undefined variable {name!r}", line)
        if path.startswith("local."):
            name = path[len("local."):]
            if name in self.variables:
                return self.variables[name]
            raise HclError(f"undefined local {name!r}", line)
        # bare identifier (e.g. unquoted enum-ish value): keep as string
        return path

    _INTERP_RE = re.compile(r"\$\{(var|local)\.([A-Za-z0-9_\-]+)\}")
    _INTERP_EXPR_RE = re.compile(r"\$\{([A-Za-z_][A-Za-z0-9_]*\([^{}]*\))\}")

    def _interp(self, s: str, line: int) -> str:
        """Substitute ${var.x}/${local.x} and parse-time function calls
        like ${upper(var.x)}; other ${...} (NOMAD_*, node.*, attr.*) are
        runtime interpolations and pass through verbatim."""

        def repl(m: re.Match) -> str:
            name = m.group(2)
            if name in self.variables:
                return str(self.variables[name])
            raise HclError(f"undefined variable {name!r}", line)

        s = self._INTERP_RE.sub(repl, s)

        def repl_fn(m: re.Match) -> str:
            inner = m.group(1)
            fname = inner.split("(", 1)[0]
            if fname not in FUNCTIONS:
                return m.group(0)     # not ours: runtime interpolation
            # every identifier argument must be a parse-time value
            # (var./local./literal); runtime refs like NOMAD_* or node.*
            # must pass through VERBATIM, not evaluate to their own name
            toks = tokenize(inner)
            for k, tok in enumerate(toks):
                if tok.kind != "ident":
                    continue
                nxt = toks[k + 1] if k + 1 < len(toks) else None
                is_call = (nxt is not None and nxt.kind == "punct"
                           and nxt.value == "(")
                if is_call or tok.value in ("true", "false", "null") \
                        or tok.value.startswith(("var.", "local.")):
                    continue
                return m.group(0)     # runtime reference: untouched
            sub = Parser(toks, variables=self.variables)
            return str(sub.parse_expr())

        return self._INTERP_EXPR_RE.sub(repl_fn, s)


def parse_hcl(src: str, variables: Optional[Dict[str, Any]] = None
              ) -> Block:
    """Parse source into a synthetic root Block. `variable` blocks at the
    root supply defaults; caller `variables` override them
    (upstream: jobspec2 ParseWithConfig VarContent/ArgVars)."""
    tokens = tokenize(src)
    # first pass without variables to harvest variable/locals defaults
    defaults: Dict[str, Any] = {}
    declared: Dict[str, Dict[str, Any]] = {}
    probe = Parser(tokens, variables=_Everything())
    try:
        items = probe.parse_body(root=True)
    except HclError:
        items = None
    if items is not None:
        for it in items:
            if isinstance(it, Block) and it.type == "variable" and it.labels:
                attrs = it.attrs()
                declared[it.labels[0]] = attrs
                if "default" in attrs:
                    defaults[it.labels[0]] = attrs["default"]
    merged = dict(defaults)
    merged.update(variables or {})
    # declared-variable contract (upstream: jobspec2 ParseWithConfig --
    # unset required variables fail UPFRONT with their names, and
    # provided values coerce to the declared type or error)
    missing = [n for n in declared
               if n not in merged]
    if missing:
        raise HclError(
            "missing required variable(s): " + ", ".join(sorted(missing)),
            0)
    for n, attrs in declared.items():
        want = str(attrs.get("type", "") or "")
        if n in merged and want:
            merged[n] = _coerce_var(n, merged[n], want)
    if items is not None and any(
            isinstance(it, Block) and it.type == "locals" for it in items):
        # locals may reference variables: re-evaluate them with the real
        # variable values. Unknown refs (e.g. a local used elsewhere in
        # the file) resolve to placeholders in THIS pass only.
        lp = Parser(tokens, variables=_Fallback(merged))
        for it in lp.parse_body(root=True):
            if isinstance(it, Block) and it.type == "locals":
                merged.update(it.attrs())
    parser = Parser(tokens, variables=merged)
    root = Block(type="root", body=parser.parse_body(root=True))
    return root


def _coerce_var(name: str, value: Any, want: str) -> Any:
    """Coerce a provided variable value to its declared type (CLI/-var
    values arrive as strings; upstream: hcl2 convert.Convert against
    the declared cty type)."""
    try:
        if want == "number":
            if isinstance(value, (int, float)):
                return value
            s = str(value)
            return float(s) if "." in s else int(s)
        if want == "bool":
            if isinstance(value, bool):
                return value
            s = str(value).lower()
            if s in ("true", "1"):
                return True
            if s in ("false", "0"):
                return False
            raise ValueError(s)
        if want == "string":
            return value if isinstance(value, str) else str(value)
        if want.startswith("list"):
            if isinstance(value, list):
                return value
            return [p.strip() for p in str(value).split(",") if p.strip()]
    except (ValueError, TypeError):
        raise HclError(
            f"variable {name!r}: value {value!r} does not match "
            f"declared type {want}", 0) from None
    return value        # unknown/complex type expressions: pass through


class _Fallback(dict):
    """Resolves known names to their real values, everything else to ''."""

    def __contains__(self, key) -> bool:
        return True

    def __getitem__(self, key):
        return self.get(key, "")


class _Everything(dict):
    """Probe-pass variable context: resolves anything to a placeholder so
    the first parse succeeds before defaults are known."""

    def __contains__(self, key) -> bool:
        return True

    def __getitem__(self, key):
        return ""
