"""Declarative topology specs — one parseable front door for every fabric.

A `TopologySpec` names a registered topology *family* plus its parameters
and an optional chain of composable *transforms*, and builds the exact same
`DiGraph` (byte-identical fingerprint) as calling the zoo constructor by
hand:

    TopologySpec.parse("torus2d:8x8").build()          == torus_2d(8, 8)
    TopologySpec.parse("dragonfly:g6,p4").build()      == dragonfly(6, 4)
    TopologySpec.parse("fattree:8p4l2h").build()       == fat_tree(8, 4, 2)
    TopologySpec.parse("hypercube:3@fail(0-1)").build()
                                    == fail_link(hypercube(3), 0, 1)

Grammar (``str(spec)`` prints the canonical form; parse/print round-trips)::

    SPEC       := FAMILY [":" PARAMS] TRANSFORM*
    PARAMS     := [COMPACT] ["," KV]* | KV ["," KV]*
    KV         := name "=" (int | "true" | "false")
    TRANSFORM  := "@" NAME "(" ARG ("-" ARG)* ["," KV]* ")"

Each family may register a COMPACT pattern (``{rows}x{cols}``,
``g{groups},p{per_group}``, ``{pods}p{leaf_per_pod}l{hosts_per_leaf}h``);
parameters not covered by the pattern — and every parameter of a family
without one — are spelled ``name=value``.  Transforms are applied left to
right: ``@fail(0-1)`` removes the bidirectional link 0<->1,
``@degrade(2-3,cap=1)`` reduces 2<->3 to capacity 1 per direction.  The
graph names they produce are the same canonical suffixes, so a degraded
fabric's display name, BENCH row and cache artifact are all self-describing.

Families and transforms self-register via the `register_topology` /
`register_transform` decorators on the zoo builders
(`repro.topo.zoo`, `repro.topo.tpu`); `zoo_specs()` exposes the committed
sweep zoo as named specs, and `resolve_topology()` accepts a `DiGraph`, a
`TopologySpec`, a committed zoo name, or a raw spec string — the form every
`repro.api.Collectives` entry point takes.
"""
from __future__ import annotations

import dataclasses
import inspect
import json
import re
from functools import lru_cache
from typing import (Any, Callable, Dict, FrozenSet, Mapping, Optional,
                    Sequence, Tuple, Union)

from repro_torch.core.graph import DiGraph

SPEC_FORMAT = "repro.topology_spec"

_FAMILY_RE = re.compile(r"^[a-z][a-z0-9_]*$")
_SPEC_RE = re.compile(
    r"^(?P<family>[a-z][a-z0-9_]*)"
    r"(?::(?P<params>[^@]*))?"
    r"(?P<transforms>(?:@[a-z][a-z0-9_]*\([^()]*\))*)$")
_TRANSFORM_RE = re.compile(r"@(?P<name>[a-z][a-z0-9_]*)\((?P<body>[^()]*)\)")
_FIELD_RE = re.compile(r"\{([a-z_][a-z0-9_]*)\}")


class TopologySpecError(ValueError):
    """A spec string / payload that does not parse or does not validate."""


# ---------------------------------------------------------------------- #
# registries
# ---------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class TopologyFamily:
    """One registered topology constructor and its spec-grammar metadata."""
    name: str
    fn: Callable[..., DiGraph]
    pattern: Optional[str]                  # compact form, e.g. "{rows}x{cols}"
    param_names: Tuple[str, ...]            # spec-settable builder params
    required: Tuple[str, ...]               # params without a default
    bool_params: FrozenSet[str]             # params whose default is a bool

    @property
    def pattern_fields(self) -> Tuple[str, ...]:
        return tuple(_FIELD_RE.findall(self.pattern)) if self.pattern else ()

    def compact_regex(self) -> Optional[re.Pattern]:
        if not self.pattern:
            return None
        out, pos = [], 0
        for m in _FIELD_RE.finditer(self.pattern):
            out.append(re.escape(self.pattern[pos:m.start()]))
            out.append(f"(?P<{m.group(1)}>\\d+)")
            pos = m.end()
        out.append(re.escape(self.pattern[pos:]))
        return re.compile("^" + "".join(out) + r"(?:,(?P<_extras>.+))?$")


_FAMILIES: Dict[str, TopologyFamily] = {}
_TRANSFORMS: Dict[str, Callable[..., DiGraph]] = {}


def register_topology(name: str, pattern: Optional[str] = None):
    """Class a zoo builder as a spec family: ``@register_topology("torus2d",
    pattern="{rows}x{cols}")``.  Parameters are read off the function
    signature (a ``name=`` display-override parameter is excluded); every
    pattern field must name an int parameter."""
    if not _FAMILY_RE.match(name):
        raise ValueError(f"family name {name!r} must match {_FAMILY_RE.pattern}")

    def deco(fn: Callable[..., DiGraph]) -> Callable[..., DiGraph]:
        sig = inspect.signature(fn)
        params, required, bools = [], [], []
        for p in sig.parameters.values():
            if p.name == "name" or p.kind not in (
                    p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY):
                continue
            params.append(p.name)
            if p.default is inspect.Parameter.empty:
                required.append(p.name)
            elif isinstance(p.default, bool):
                bools.append(p.name)
        entry = TopologyFamily(name=name, fn=fn, pattern=pattern,
                               param_names=tuple(params),
                               required=tuple(required),
                               bool_params=frozenset(bools))
        for f in entry.pattern_fields:
            if f not in entry.param_names:
                raise ValueError(
                    f"family {name!r}: pattern field {f!r} is not a "
                    f"parameter of {fn.__qualname__}")
        prev = _FAMILIES.get(name)
        if prev is not None and prev.fn.__qualname__ != fn.__qualname__:
            raise ValueError(f"topology family {name!r} already registered "
                             f"to {prev.fn.__qualname__}")
        _FAMILIES[name] = entry
        return fn

    return deco


def register_transform(name: str):
    """Register a ``fn(g, *int_args, **int_kwargs) -> DiGraph`` graph
    transform under ``@name(...)`` in the spec grammar."""
    if not _FAMILY_RE.match(name):
        raise ValueError(f"transform name {name!r} must match "
                         f"{_FAMILY_RE.pattern}")

    def deco(fn: Callable[..., DiGraph]) -> Callable[..., DiGraph]:
        prev = _TRANSFORMS.get(name)
        if prev is not None and prev.__qualname__ != fn.__qualname__:
            raise ValueError(f"transform {name!r} already registered to "
                             f"{prev.__qualname__}")
        _TRANSFORMS[name] = fn
        return fn

    return deco


def _ensure_registry() -> None:
    """Importing the zoo modules runs their registration decorators."""
    from repro_torch.topo import tpu, zoo  # noqa: F401  (import side effects)


def topology_families() -> Dict[str, TopologyFamily]:
    """All registered families (name -> entry), zoo included."""
    _ensure_registry()
    return dict(_FAMILIES)


def transform_names() -> Tuple[str, ...]:
    _ensure_registry()
    return tuple(sorted(_TRANSFORMS))


def _family(name: str) -> TopologyFamily:
    _ensure_registry()
    try:
        return _FAMILIES[name]
    except KeyError:
        raise TopologySpecError(
            f"unknown topology family {name!r} (known: "
            f"{', '.join(sorted(_FAMILIES))})") from None


# ---------------------------------------------------------------------- #
# value plumbing
# ---------------------------------------------------------------------- #

def _format_value(v: Any) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    return str(v)


def _parse_value(family: TopologyFamily, key: str, raw: str) -> Any:
    raw = raw.strip()
    if key in family.bool_params:
        if raw in ("true", "1"):
            return True
        if raw in ("false", "0"):
            return False
        raise TopologySpecError(
            f"{family.name}: parameter {key!r} takes true/false, got {raw!r}")
    try:
        return int(raw)
    except ValueError:
        raise TopologySpecError(
            f"{family.name}: parameter {key!r} must be an integer, "
            f"got {raw!r}") from None


def _parse_kv_tokens(family: TopologyFamily, text: str,
                     into: Dict[str, Any]) -> None:
    for tok in text.split(","):
        tok = tok.strip()
        if not tok:
            raise TopologySpecError(
                f"{family.name}: empty parameter token in {text!r}")
        if "=" not in tok:
            raise TopologySpecError(
                f"{family.name}: expected name=value, got {tok!r} "
                f"(compact form: {family.pattern or 'none'})")
        key, raw = tok.split("=", 1)
        key = key.strip()
        if key not in family.param_names:
            raise TopologySpecError(
                f"{family.name}: unknown parameter {key!r} "
                f"(takes {', '.join(family.param_names)})")
        if key in into:
            raise TopologySpecError(
                f"{family.name}: parameter {key!r} given twice")
        into[key] = _parse_value(family, key, raw)


# ---------------------------------------------------------------------- #
# TransformSpec
# ---------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class TransformSpec:
    """One graph transform application: ``@name(a-b,key=v)``."""
    name: str
    args: Tuple[int, ...] = ()
    kwargs: Tuple[Tuple[str, int], ...] = ()

    def __post_init__(self) -> None:
        object.__setattr__(self, "args", tuple(int(a) for a in self.args))
        kw = self.kwargs.items() if isinstance(self.kwargs, Mapping) \
            else self.kwargs
        object.__setattr__(
            self, "kwargs", tuple(sorted((str(k), int(v)) for k, v in kw)))

    def __str__(self) -> str:
        toks = ["-".join(str(a) for a in self.args)] if self.args else []
        toks += [f"{k}={v}" for k, v in self.kwargs]
        return f"@{self.name}({','.join(toks)})"

    @classmethod
    def parse_text(cls, text: str) -> "TransformSpec":
        """Parse one standalone transform — ``"@fail(0-1)"``,
        ``"@degrade(2-3,cap=1)"`` — the form `Collectives.repair` and the
        launch drivers' ``--inject-fault`` take."""
        m = _TRANSFORM_RE.fullmatch(text.strip())
        if not m:
            raise TopologySpecError(
                f"malformed transform {text!r} (expected '@name(a-b,k=v)')")
        return cls.parse(m.group("name"), m.group("body"))

    @classmethod
    def parse(cls, name: str, body: str) -> "TransformSpec":
        args: Tuple[int, ...] = ()
        kwargs = {}
        for i, tok in enumerate(t.strip() for t in body.split(",") if
                                t.strip()):
            if "=" in tok:
                k, raw = tok.split("=", 1)
                try:
                    kwargs[k.strip()] = int(raw)
                except ValueError:
                    raise TopologySpecError(
                        f"@{name}: {tok!r} is not name=int") from None
            elif i == 0:
                try:
                    args = tuple(int(a) for a in tok.split("-"))
                except ValueError:
                    raise TopologySpecError(
                        f"@{name}: positional args {tok!r} must be "
                        f"'-'-separated integers") from None
            else:
                raise TopologySpecError(
                    f"@{name}: positional token {tok!r} must come first")
        return cls(name=name, args=args, kwargs=tuple(kwargs.items()))

    def apply(self, g: DiGraph) -> DiGraph:
        _ensure_registry()
        try:
            fn = _TRANSFORMS[self.name]
        except KeyError:
            raise TopologySpecError(
                f"unknown transform {self.name!r} (known: "
                f"{', '.join(sorted(_TRANSFORMS))})") from None
        try:
            return fn(g, *self.args, **dict(self.kwargs))
        except TypeError as e:
            raise TopologySpecError(f"{self}: {e}") from None


# ---------------------------------------------------------------------- #
# TopologySpec
# ---------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class TopologySpec:
    """A declarative, serializable recipe for a topology.

    ``params`` holds only the explicitly-given builder parameters (builder
    defaults fill the rest at `build()` time), normalized to a sorted tuple
    so equal specs compare and hash equal."""
    family: str
    params: Tuple[Tuple[str, Any], ...] = ()
    transforms: Tuple[TransformSpec, ...] = ()

    def __post_init__(self) -> None:
        items = self.params.items() if isinstance(self.params, Mapping) \
            else self.params
        object.__setattr__(
            self, "params", tuple(sorted((str(k), v) for k, v in items)))
        object.__setattr__(self, "transforms", tuple(self.transforms))

    # -------------------------------------------------------------- #
    # parse / print
    # -------------------------------------------------------------- #

    @classmethod
    def parse(cls, text: str) -> "TopologySpec":
        m = _SPEC_RE.match(text.strip())
        if not m:
            raise TopologySpecError(f"malformed topology spec {text!r}")
        family = _family(m.group("family"))
        params: Dict[str, Any] = {}
        body = (m.group("params") or "").strip()
        if m.group("params") is not None and not body:
            raise TopologySpecError(
                f"{family.name}: ':' must be followed by parameters")
        if body:
            compact = family.compact_regex()
            cm = compact.match(body) if compact else None
            if cm:
                extras = cm.groupdict().pop("_extras", None)
                for f in family.pattern_fields:
                    params[f] = int(cm.group(f))
                if extras:
                    _parse_kv_tokens(family, extras, params)
            else:
                _parse_kv_tokens(family, body, params)
        spec = cls(family=family.name, params=tuple(params.items()),
                   transforms=tuple(
                       TransformSpec.parse(t.group("name"), t.group("body"))
                       for t in _TRANSFORM_RE.finditer(
                           m.group("transforms") or "")))
        spec.validate()
        return spec

    def __str__(self) -> str:
        out = self.family
        body = self._params_str()
        if body:
            out += f":{body}"
        return out + "".join(str(t) for t in self.transforms)

    def _params_str(self) -> str:
        params = dict(self.params)
        if not params:
            return ""
        entry = _family(self.family)
        fields = entry.pattern_fields
        toks = []
        if fields and all(f in params for f in fields):
            toks.append(entry.pattern.format(
                **{f: params.pop(f) for f in fields}))
        toks += [f"{k}={_format_value(v)}" for k, v in sorted(params.items())]
        return ",".join(toks)

    # -------------------------------------------------------------- #
    # JSON round-trip
    # -------------------------------------------------------------- #

    def to_dict(self) -> Dict[str, Any]:
        return {
            "format": SPEC_FORMAT,
            "family": self.family,
            "params": dict(self.params),
            "transforms": [{"name": t.name, "args": list(t.args),
                            "kwargs": dict(t.kwargs)}
                           for t in self.transforms],
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "TopologySpec":
        if d.get("format", SPEC_FORMAT) != SPEC_FORMAT:
            raise TopologySpecError(f"not a topology-spec payload: "
                                    f"{d.get('format')!r}")
        try:
            spec = cls(
                family=d["family"],
                params=tuple(dict(d.get("params", {})).items()),
                transforms=tuple(
                    TransformSpec(name=t["name"],
                                  args=tuple(t.get("args", ())),
                                  kwargs=tuple(dict(t.get("kwargs",
                                                          {})).items()))
                    for t in d.get("transforms", ())))
        except (KeyError, TypeError) as e:
            raise TopologySpecError(f"malformed spec payload: {e}") from None
        spec.validate()
        return spec

    @classmethod
    def from_json(cls, text: str) -> "TopologySpec":
        try:
            return cls.from_dict(json.loads(text))
        except json.JSONDecodeError as e:
            raise TopologySpecError(f"spec JSON does not parse: {e}") \
                from None

    # -------------------------------------------------------------- #
    # composition / build
    # -------------------------------------------------------------- #

    def with_transform(self, name: str, *args: int,
                       **kwargs: int) -> "TopologySpec":
        """Append a transform: ``spec.with_transform("degrade", 2, 3,
        cap=1)`` == parsing ``...@degrade(2-3,cap=1)``."""
        t = TransformSpec(name=name, args=args, kwargs=tuple(kwargs.items()))
        return dataclasses.replace(self,
                                   transforms=self.transforms + (t,))

    def fail(self, u: int, v: int) -> "TopologySpec":
        return self.with_transform("fail", u, v)

    def degrade(self, u: int, v: int, cap: int) -> "TopologySpec":
        return self.with_transform("degrade", u, v, cap=cap)

    def validate(self) -> None:
        """Family exists, every param is known, required params present
        whenever any is, and every transform is registered."""
        entry = _family(self.family)
        params = dict(self.params)
        for k in params:
            if k not in entry.param_names:
                raise TopologySpecError(
                    f"{self.family}: unknown parameter {k!r} "
                    f"(takes {', '.join(entry.param_names)})")
        missing = [r for r in entry.required if r not in params]
        if missing:
            raise TopologySpecError(
                f"{self.family}: missing required parameter(s) "
                f"{', '.join(missing)}")
        _ensure_registry()
        for t in self.transforms:
            if t.name not in _TRANSFORMS:
                raise TopologySpecError(f"unknown transform {t.name!r}")

    def build(self) -> DiGraph:
        """Construct the graph — byte-identical (same `fingerprint()`) to
        calling the registered zoo builder with the same parameters."""
        entry = _family(self.family)
        params = dict(self.params)
        missing = [r for r in entry.required if r not in params]
        if missing:
            raise TopologySpecError(
                f"{self.family}: missing required parameter(s) "
                f"{', '.join(missing)}")
        g = entry.fn(**params)
        for t in self.transforms:
            g = t.apply(g)
        return g


# ---------------------------------------------------------------------- #
# zoo table + resolution
# ---------------------------------------------------------------------- #

@lru_cache(maxsize=1)
def _zoo_specs() -> Tuple[Tuple[str, TopologySpec], ...]:
    from repro_torch.topo import zoo
    return tuple((name, TopologySpec.parse(text))
                 for name, text in zoo.ZOO_SPECS.items())


def zoo_specs() -> Dict[str, TopologySpec]:
    """The committed sweep zoo as ``{row_name: TopologySpec}`` — the single
    registry `repro.cache.sweep.sweep_registry()`, BENCH row names and the
    ``--topology`` CLI all derive from."""
    return dict(_zoo_specs())


SpecLike = Union[DiGraph, TopologySpec, str]


def resolve_topology(obj: SpecLike) -> DiGraph:
    """A `DiGraph` passes through; a `TopologySpec` builds; a string is a
    committed zoo name (``"torus8x8_failed"``) or a raw spec
    (``"torus2d:8x8@fail(0-1)"``)."""
    if isinstance(obj, DiGraph):
        return obj
    if isinstance(obj, TopologySpec):
        return obj.build()
    if isinstance(obj, str):
        zoo = zoo_specs()
        if obj in zoo:
            return zoo[obj].build()
        return TopologySpec.parse(obj).build()
    raise TypeError(f"cannot resolve a topology from {type(obj).__name__!r} "
                    f"(takes DiGraph | TopologySpec | spec string)")
