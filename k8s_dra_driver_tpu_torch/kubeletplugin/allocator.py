"""Structured allocator: binds ResourceClaims against published slices.

In a real cluster this work belongs to the kube-scheduler's DRA plugin; the
reference therefore tests allocation with a live (kind) cluster. This repo's
test substrate is the in-memory API, so allocation is reimplemented here in
structured form (copied from the JAX package's allocator, which it decides
exactly like on the same objects, the defrag planner's placement options,
the fragmentation report and the extended-resource claim synthesis
included):

- honors ``deviceClassName`` (DeviceClass objects may carry selectors too),
- request selectors (a CEL subset evaluated against ``device.attributes`` /
  ``device.capacity``),
- ``allocationMode``: ExactCount (with ``count``) or All,
- KEP-4815 shared-counter accounting: a device is allocatable only if every
  counter it consumes still has capacity left after subtracting the
  consumption of all devices already allocated from the same CounterSet
  (the mechanism that makes overlapping subslices impossible by
  construction — cf. ``cmd/gpu-kubelet-plugin/partitions.go:70-232``),
- NoSchedule device taints exclude devices from new allocations (KEP-5055),
- writes ``status.allocation`` + ``status.reservedFor`` back to the claim.
"""

from __future__ import annotations

import ast
import logging
import re
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Iterable, Optional

from k8s_dra_driver_tpu_torch.k8sclient.client import FakeClient, Obj
from k8s_dra_driver_tpu_torch.pkg import sanitizer
from k8s_dra_driver_tpu_torch.kubeletplugin.types import attr_plain, claim_requests
from k8s_dra_driver_tpu_torch.pkg import tracing
from k8s_dra_driver_tpu_torch.pkg.metrics import (
    AllocatorMetrics,
    default_allocator_metrics,
)
from k8s_dra_driver_tpu_torch.gpulib.topology import Box, Topology

logger = logging.getLogger(__name__)

#: Annotation of a synthetic canary claim: allocated last-fit so that it
#: never contends with a real claim for the first free device.
ANN_CANARY = "gpu.nvidia.com/canary"


#: Annotation naming the extended resources an implicit claim stands for
#: (KEP-5004; the scheduler sets it on the claims it synthesizes).
ANN_EXTENDED_RESOURCE_NAMES = "resource.kubernetes.io/extended-resource-names"


class AllocationError(RuntimeError):
    pass


class _MissingKey(Exception):
    """A lookup of an absent attribute/capacity key (CEL runtime error)."""


_SEMVER_RE = re.compile(
    r"(0|[1-9]\d*)\.(0|[1-9]\d*)\.(0|[1-9]\d*)"
    r"(?:-([0-9A-Za-z.-]+))?(?:\+[0-9A-Za-z.-]+)?\Z")


class _Semver:
    """Parsed semantic version, comparable via compareTo (the CEL semver
    extension the k8s DRA selectors use — reference e2e:
    ``driverVersion.compareTo(semver("1.2.3")) >= 0``,
    test/e2e/framework/specs/driver-version.yaml.tmpl:21).

    Full semver-2.0 precedence: a prerelease orders BELOW its release
    (1.0.0-rc1 < 1.0.0), prerelease identifiers compare numerically when
    numeric and lexically otherwise (numeric < alphanumeric), and fewer
    identifiers order below more when equal so far. Leading zeros are
    rejected, matching the real CEL parser."""

    def __init__(self, key: tuple):
        self._key = key

    @staticmethod
    def parse(s: str) -> "_Semver":
        m = _SEMVER_RE.match(s.strip())
        if not m:
            raise AllocationError(f"invalid semver {s!r}")
        release = tuple(int(g) for g in m.groups()[:3])
        pre = m.group(4)
        if pre is None:
            return _Semver((release, (1,)))
        ids = []
        for part in pre.split("."):
            if not part:
                raise AllocationError(f"invalid semver {s!r}: empty "
                                      "prerelease identifier")
            if part.isdigit():
                if len(part) > 1 and part[0] == "0":
                    raise AllocationError(
                        f"invalid semver {s!r}: leading zero in {part!r}")
                ids.append((0, int(part), ""))
            else:
                ids.append((1, 0, part))
        return _Semver((release, (0, tuple(ids))))

    def __eq__(self, other) -> bool:
        return isinstance(other, _Semver) and self._key == other._key

    def __lt__(self, other: "_Semver") -> bool:
        return self._key < other._key

    def __gt__(self, other: "_Semver") -> bool:
        return other < self

    def __hash__(self) -> int:
        return hash(self._key)


_QUANTITY_SUFFIXES = {
    "Ki": 1 << 10, "Mi": 1 << 20, "Gi": 1 << 30, "Ti": 1 << 40,
    "Pi": 1 << 50, "k": 10**3, "M": 10**6, "G": 10**9, "T": 10**12,
}

# Longest-suffix-first match order, computed once — _parse_quantity is on
# the per-device selector eval path and used to re-sort this per call.
_QUANTITY_SUFFIXES_DESC = sorted(_QUANTITY_SUFFIXES.items(),
                                 key=lambda kv: -len(kv[0]))


def _parse_quantity(s: str) -> int:
    """k8s resource.Quantity subset ("40Gi", "16G", "1024") → plain number,
    comparable against our capacity values (stored as plain ints — e.g.
    hbm bytes). The CEL quantity() extension analogue."""
    s = s.strip()
    for suffix, mult in _QUANTITY_SUFFIXES_DESC:
        if s.endswith(suffix):
            try:
                # OverflowError: float parses 'inf'/'1e400' but int() of it
                # explodes — still just an invalid selector.
                return int(float(s[:-len(suffix)]) * mult)
            except (ValueError, OverflowError) as e:
                raise AllocationError(f"invalid quantity {s!r}") from e
    try:
        return int(float(s))
    except (ValueError, OverflowError) as e:
        raise AllocationError(f"invalid quantity {s!r}") from e


def _compare_to(left: Any, right: Any) -> int:
    """CEL compareTo semantics: -1/0/1. Version-vs-version and
    number-vs-number; a string left is parsed as semver when the right side
    is one (version-typed attributes surface as plain strings here)."""
    if isinstance(right, _Semver):
        if isinstance(left, str):
            left = _Semver.parse(left)
        if not isinstance(left, _Semver):
            raise AllocationError("compareTo(semver) on a non-version value")
    elif isinstance(right, (int, float)) and not isinstance(right, bool):
        if isinstance(left, str):
            left = _parse_quantity(left)
        if not isinstance(left, (int, float)) or isinstance(left, bool):
            raise AllocationError("compareTo(number) on a non-number value")
    else:
        raise AllocationError("compareTo expects semver() or quantity()")
    return (left > right) - (left < right)


class _SelectorInterp:
    """AST-whitelist interpreter for the CEL selector subset.

    Expressions are parsed with :mod:`ast` and walked node-by-node against an
    explicit whitelist — there is no ``eval`` and no access to Python builtins
    or attributes beyond ``device.attributes`` / ``device.capacity``. Anything
    outside the whitelist (calls, comprehensions, dunder access, arbitrary
    names) raises :class:`AllocationError` at parse time.
    """

    #: maps CEL map names reachable via ``device.<name>[...]``
    _MAPS = ("attributes", "capacity")

    def __init__(self, device: dict[str, Any]):
        self._maps = {
            "attributes": device.get("attributes", {}),
            "capacity": device.get("capacity", {}),
        }

    def eval(self, node: ast.AST) -> Any:
        if isinstance(node, ast.Expression):
            return self.eval(node.body)
        if isinstance(node, ast.Constant):
            if node.value is None or isinstance(node.value, (bool, int, float, str)):
                return node.value
            raise AllocationError(f"unsupported literal {node.value!r}")
        if isinstance(node, ast.Name):
            if node.id == "true":
                return True
            if node.id == "false":
                return False
            raise AllocationError(f"unknown identifier {node.id!r}")
        if isinstance(node, ast.BoolOp):
            if isinstance(node.op, ast.And):
                return all(self._truthy(v) for v in node.values)
            return any(self._truthy(v) for v in node.values)
        if isinstance(node, ast.UnaryOp):
            if isinstance(node.op, ast.Not):
                return not self._truthy(node.operand)
            if isinstance(node.op, ast.USub):
                operand = self.eval(node.operand)
                if not isinstance(operand, (int, float)):
                    raise AllocationError("unary minus on non-number")
                return -operand
            raise AllocationError("unsupported unary operator")
        if isinstance(node, ast.Compare):
            left = self.eval(node.left)
            for op, rhs_node in zip(node.ops, node.comparators):
                rhs = self.eval(rhs_node)
                if not self._compare(op, left, rhs):
                    return False
                left = rhs
            return True
        if isinstance(node, ast.Attribute):
            # Only device.attributes / device.capacity, as bare maps for
            # `'key' in device.attributes` containment.
            if (isinstance(node.value, ast.Name) and node.value.id == "device"
                    and node.attr in self._MAPS):
                return self._maps[node.attr]
            raise AllocationError(f"unsupported attribute access {ast.dump(node)}")
        if isinstance(node, ast.Subscript):
            container = self.eval(node.value)
            if not isinstance(container, dict):
                raise AllocationError("subscript of non-map")
            key = self.eval(node.slice)
            if key not in container:
                raise _MissingKey(key)
            return container[key]
        if isinstance(node, ast.Call):
            return self._call(node)
        raise AllocationError(
            f"unsupported selector syntax: {type(node).__name__}")

    #: whitelisted value methods (the CEL string/comparison extensions the
    #: reference's selectors use: matches/lowerAscii per
    #: product-type.yaml.tmpl:21, compareTo per driver-version.yaml.tmpl:21)
    _METHODS = ("matches", "lowerAscii", "startsWith", "endsWith",
                "contains", "compareTo")

    def _call(self, node: ast.Call) -> Any:
        if node.keywords:
            raise AllocationError("keyword arguments are not CEL")
        args = [self.eval(a) for a in node.args]
        # Global constructors: semver("1.2.3"), quantity("40Gi").
        if isinstance(node.func, ast.Name):
            name = node.func.id
            if name == "semver" and len(args) == 1 and isinstance(args[0], str):
                return _Semver.parse(args[0])
            if name == "quantity" and len(args) == 1 and isinstance(args[0], str):
                return _parse_quantity(args[0])
            raise AllocationError(f"unknown function {name!r}")
        # Value methods: receiver.method(args).
        if not (isinstance(node.func, ast.Attribute)
                and node.func.attr in self._METHODS):
            raise AllocationError("unsupported call target")
        method = node.func.attr
        recv = self.eval(node.func.value)
        if method == "compareTo":
            if len(args) != 1:
                raise AllocationError("compareTo takes one argument")
            return _compare_to(recv, args[0])
        if not isinstance(recv, str):
            raise AllocationError(f".{method}() on a non-string value")
        if method == "lowerAscii":
            if args:
                raise AllocationError("lowerAscii takes no arguments")
            return recv.lower()
        if len(args) != 1 or not isinstance(args[0], str):
            raise AllocationError(f".{method}() takes one string argument")
        if method == "matches":
            # CEL matches = unanchored RE2 search.
            try:
                return re.search(args[0], recv) is not None
            except re.error as e:
                raise AllocationError(f"invalid regex {args[0]!r}: {e}") from e
        if method == "startsWith":
            return recv.startswith(args[0])
        if method == "endsWith":
            return recv.endswith(args[0])
        return args[0] in recv  # contains

    def _truthy(self, node: ast.AST) -> bool:
        val = self.eval(node)
        if not isinstance(val, bool):
            raise AllocationError("non-boolean operand in boolean context")
        return val

    @staticmethod
    def _compare(op: ast.cmpop, left: Any, right: Any) -> bool:
        if isinstance(op, ast.Eq):
            return left == right
        if isinstance(op, ast.NotEq):
            return left != right
        if isinstance(op, (ast.In, ast.NotIn)):
            try:
                contained = left in right
            except TypeError as e:
                raise AllocationError(f"'in' on non-container: {e}") from e
            return contained if isinstance(op, ast.In) else not contained
        # Ordered comparisons only between mutually comparable scalars.
        if not (isinstance(left, (int, float, str))
                and isinstance(right, (int, float, str))):
            raise AllocationError("ordered comparison of non-scalars")
        if isinstance(left, str) != isinstance(right, str):
            raise AllocationError("ordered comparison of mixed types")
        if isinstance(op, ast.Lt):
            return left < right
        if isinstance(op, ast.LtE):
            return left <= right
        if isinstance(op, ast.Gt):
            return left > right
        if isinstance(op, ast.GtE):
            return left >= right
        raise AllocationError("unsupported comparison operator")


def _cel_to_python(expr: str) -> str:
    """Rewrite CEL's ``&&``/``||``/``!`` to Python keywords, skipping quoted
    string literals so an operator character inside a value (``'a&&b'``) is
    never corrupted."""
    out: list[str] = []
    i, n = 0, len(expr)
    quote: Optional[str] = None
    while i < n:
        ch = expr[i]
        if quote is not None:
            if ch == "\\" and i + 1 < n:
                out.append(expr[i:i + 2])
                i += 2
                continue
            if ch == quote:
                quote = None
            out.append(ch)
            i += 1
            continue
        if ch in ("'", '"'):
            quote = ch
            out.append(ch)
        elif expr.startswith("&&", i):
            out.append(" and ")
            i += 2
            continue
        elif expr.startswith("||", i):
            out.append(" or ")
            i += 2
            continue
        elif ch == "!" and not expr.startswith("!=", i):
            out.append(" not ")
        else:
            out.append(ch)
        i += 1
    return "".join(out).strip()


# Compiled-selector LRU: the CEL→Python rewrite + ast.parse dominate a
# selector eval for short expressions, and the same handful of class /
# request selector strings is evaluated against every candidate device on
# every allocation. The AST is walk-only downstream (never mutated), so
# sharing one tree across evaluations — and threads — is safe.
_SELECTOR_CACHE_MAX = 512
_selector_cache: "OrderedDict[str, ast.Expression]" = OrderedDict()
_selector_cache_mu = sanitizer.new_lock("allocator._selector_cache_mu")


def _compile_selector(expression: str) -> ast.Expression:
    metrics = default_allocator_metrics()
    with _selector_cache_mu:
        tree = _selector_cache.get(expression)
        if tree is not None:
            _selector_cache.move_to_end(expression)
            metrics.hit("selector")
            return tree
    metrics.miss("selector")
    try:
        # ValueError: NUL bytes; RecursionError/MemoryError: pathological
        # nesting — all are invalid selectors, not crashes.
        tree = ast.parse(_cel_to_python(expression), mode="eval")
    except (SyntaxError, ValueError, RecursionError, MemoryError) as e:
        raise AllocationError(
            f"invalid selector expression {expression!r}: {e}") from e
    with _selector_cache_mu:
        _selector_cache[expression] = tree
        while len(_selector_cache) > _SELECTOR_CACHE_MAX:
            _selector_cache.popitem(last=False)
            # Counted, never silent: a workload cycling more distinct
            # selector strings than the cap thrashes this cache, and the
            # operator should see that instead of diagnosing a mystery
            # slowdown (docs/performance.md).
            metrics.evict("selector")
    return tree


def eval_selector(expression: str, device: dict[str, Any]) -> bool:
    """Evaluate a CEL-subset selector expression against one device.

    Supports the patterns the demo specs and e2e tests use:
    ``device.attributes['driver/attr'] == 'v5e'``, numeric comparisons on
    ``device.capacity[...]``, ``&&``/``||``/``!``, and ``in``. This is a
    test-substrate evaluator, not a CEL engine — real clusters use the
    scheduler's CEL. Evaluation is a whitelist AST walk (see
    :class:`_SelectorInterp`), never ``eval``; parse results are shared
    through an LRU keyed by the expression string. Unknown attribute
    lookups make the selector false (CEL runtime-error semantics for
    missing keys).
    """
    tree = _compile_selector(expression)
    try:
        result = _SelectorInterp(device).eval(tree)
    except _MissingKey:
        return False
    except RecursionError as e:
        raise AllocationError(
            f"invalid selector expression {expression!r}: too deeply nested") from e
    except AllocationError as e:
        raise AllocationError(
            f"invalid selector expression {expression!r}: {e}") from e
    if not isinstance(result, bool):
        raise AllocationError(
            f"selector expression {expression!r} is not boolean-valued")
    return result


def _device_view(dev: dict[str, Any]) -> dict[str, Any]:
    """Published device dict → plain attribute/capacity values for eval."""
    return {
        "attributes": {k: attr_plain(v)
                       for k, v in (dev.get("attributes") or {}).items()},
        "capacity": {k: v.get("value")
                     for k, v in (dev.get("capacity") or {}).items()},
    }


def _has_noschedule_taint(dev: dict[str, Any]) -> bool:
    return any(t.get("effect") in ("NoSchedule", "NoExecute")
               for t in dev.get("taints") or [])


@dataclass
class _Candidate:
    pool: str
    driver: str
    device: dict[str, Any]
    # Precomputed selector-eval view and the owning slice's node pinning —
    # filled by the slice index so neither is rebuilt per allocation.
    view: dict[str, Any] = field(default_factory=dict)
    node: Optional[str] = None
    #: (pool, device name) — the usage-index key, precomputed off the
    #: per-pick hot path.
    key: tuple = ()
    #: the candidate's geometry box (None for non-geometry devices) —
    #: linked by _build_geometry so the pick loop does zero dict walks.
    geo: Optional["_GeoBox"] = None

    @property
    def name(self) -> str:
        return self.device["name"]


@dataclass
class _GeoBox:
    """One geometry-indexed placement: a device (chip or subslice) whose
    counter draws are all unit-valued, viewed as a box of chips. The
    counter-key set is the ground truth for containment/overlap — it is
    what KEP-4815 accounting actually enforces — while ``box`` carries
    the parsed mesh geometry for validation and reporting."""

    name: str
    pool: str
    counters: frozenset          # pool-local (counter_set, counter) keys
    volume: int                  # chips inside (== len(counters))
    shape: str                   # "2x2" for subslices, "chip" for chips
    box: Optional[Box] = None
    #: bitmask over the pool's unit counters (one bit per chip) — the
    #: hot-path form of ``counters``: freeness is one ``mask & dirty``.
    mask: int = 0
    # Linked by _PoolGeometry.link():
    containers: tuple = ()       # _GeoBox strictly containing, volume asc
    overlapping: tuple = ()      # _GeoBox sharing >= 1 chip (excl. self)
    #: ``overlapping`` masks grouped by shape — the destroyed-shapes
    #: census short-circuits per group instead of walking every box.
    overlap_groups: tuple = ()   # tuple[tuple[int, ...], ...]


@dataclass
class _PoolGeometry:
    """The free-box index of one pool (docs/performance.md,
    "Topology-aware allocation"): every unit-counter placement with its
    precomputed containment chain and overlap set. Static per
    ResourceSlice generation; the DYNAMIC half (which boxes are free) is
    read off the usage index's dirty-counter sets, so freeness needs no
    structure rebuild on allocate/release."""

    pool: str
    node: Optional[str] = None
    boxes: dict[str, _GeoBox] = field(default_factory=dict)
    #: all unit-valued counter keys in the pool's counter sets — the
    #: "chips" the fragmentation gauge counts.
    unit_counters: frozenset = frozenset()
    #: counter key → bit index, assigned at build; scoring works on the
    #: resulting int masks instead of tuple-key sets.
    bit_of: dict = field(default_factory=dict)
    #: the implicit whole-pool box (every unit counter): the outermost
    #: container in every chain and the "largest allocatable" ceiling.
    whole: Optional[_GeoBox] = None
    topology: Optional[Topology] = None

    def link(self) -> None:
        """Precompute containment chains and overlap sets (pairwise on
        the counter keys — O(n²) per slice generation over ~dozens of
        placements per pool, never per claim)."""
        geos = list(self.boxes.values())
        for g in geos:
            containers = [o for o in geos
                          if o.volume > g.volume
                          and g.counters <= o.counters]
            if (self.whole is not None
                    and self.whole.volume > g.volume
                    and g.counters <= self.whole.counters):
                containers.append(self.whole)
            containers.sort(key=lambda o: (o.volume, o.name))
            g.containers = tuple(containers)
            g.overlapping = tuple(
                o for o in geos
                if o is not g and not o.counters.isdisjoint(g.counters))
            by_shape: dict[str, list[int]] = {}
            for o in g.overlapping:
                by_shape.setdefault(o.shape, []).append(o.mask)
            g.overlap_groups = tuple(tuple(ms)
                                     for ms in by_shape.values())

    def dirty_mask(self, dirty: set) -> int:
        """The pool's dirty counter keys as a chip bitmask (unknown keys
        — non-unit counters — simply do not participate in geometry).
        Build-time only; the hot paths carry the mask incrementally."""
        mask = 0
        bit_of = self.bit_of
        for key in dirty:
            b = bit_of.get(key)
            if b is not None:
                mask |= 1 << b
        return mask

    def free_units(self, mask: int) -> int:
        return len(self.unit_counters) - mask.bit_count()

    def largest_free(self, mask: int) -> tuple[int, str]:
        """(volume, shape) of the biggest fully-free placement —
        including the implicit whole-pool box when nothing is drawn."""
        best, shape = 0, ""
        if self.whole is not None and not self.whole.mask & mask:
            return self.whole.volume, self.whole.shape
        for g in self.boxes.values():
            if g.volume > best and not g.mask & mask:
                best, shape = g.volume, g.shape
        return best, shape

    def fragmentation(self, mask: int) -> dict[str, Any]:
        """The gauge's definition: 1 − largest-allocatable-subslice ÷
        free-chips. 0 = the free capacity forms one allocatable box;
        → 1 as it splinters into placement-useless shards. A full pool
        (no free chips) reads 0 — nothing is fragmented, it is simply
        full."""
        free = self.free_units(mask)
        largest, shape = self.largest_free(mask)
        frag = 0.0 if free == 0 else round(1.0 - largest / free, 4)
        return {"pool": self.pool, "node": self.node or "",
                "free_chips": free, "largest_free": largest,
                "largest_free_shape": shape, "fragmentation": frag}


@dataclass
class _SliceIndex:
    """Everything derivable from the ResourceSlices alone, built once per
    ResourceSlice write generation: untainted candidates with precomputed
    eval views, the (pool, device) → definition map counter accounting
    needs, the shared-counter capacities, and the per-pool free-box
    geometry."""

    candidates: list[_Candidate] = field(default_factory=list)
    by_pool_device: dict[tuple[str, str], dict[str, Any]] = field(
        default_factory=dict)
    capacity: dict[tuple[str, str, str], int] = field(default_factory=dict)
    geometry: dict[str, _PoolGeometry] = field(default_factory=dict)


def _unit_draws(dev: dict[str, Any]) -> Optional[frozenset]:
    """The device's counter keys when every draw is exactly 1 unit (the
    chip-granularity KEP-4815 shape the geometry index covers); None for
    counterless or non-unit devices."""
    ccs = dev.get("consumesCounters") or []
    if not ccs:
        return None
    keys = []
    for cc in ccs:
        for cname, cval in cc.get("counters", {}).items():
            if cval.get("value") != 1:
                return None
            keys.append((cc.get("counterSet", ""), cname))
    return frozenset(keys)


def _device_box(dev: dict[str, Any]) -> Optional[Box]:
    """Parse the published mesh geometry: subslices carry shape+origin
    attributes (partitions.py); anything unparseable is simply not
    box-annotated (the counter keys stay authoritative)."""
    attrs = {k: attr_plain(v) for k, v in (dev.get("attributes") or {}).items()}
    shape, origin = attrs.get("shape"), attrs.get("origin")
    if not shape or origin is None:
        return None
    try:
        return Box(origin=tuple(int(p) for p in str(origin).split("-")),
                   shape=Box.parse_shape(str(shape)))
    except (ValueError, TypeError):
        return None


def _build_geometry(idx: "_SliceIndex",
                    pool_nodes: dict[str, Optional[str]]) -> None:
    """Fill ``idx.geometry``: one :class:`_PoolGeometry` per pool that
    publishes unit-counter devices. The host topology is derived from the
    published boxes (max extent per axis) and kept only when it accounts
    for every unit counter and every box is a valid aligned subslice of
    it — a pool publishing non-mesh counters degrades to pure counter-set
    math, never to wrong geometry."""
    pools: dict[str, _PoolGeometry] = {}
    for (pool, _name), dev in idx.by_pool_device.items():
        geo = pools.get(pool)
        if geo is None:
            geo = pools[pool] = _PoolGeometry(
                pool=pool, node=pool_nodes.get(pool))
        counters = _unit_draws(dev)
        if counters is None:
            continue
        attrs = dev.get("attributes") or {}
        shape = str(attr_plain(attrs.get("shape", {})) or "") if attrs else ""
        geo.boxes[dev["name"]] = _GeoBox(
            name=dev["name"], pool=pool, counters=counters,
            volume=len(counters),
            shape=shape or ("chip" if len(counters) == 1 else
                            str(len(counters))),
            box=_device_box(dev))
    for pool, geo in pools.items():
        if not geo.boxes:
            continue
        # A device whose box covers fewer cells than the unit counters it
        # draws also draws a counter outside the mesh (a GPU's media
        # engines): as a box its containment would be wrong, so it stays
        # on the counter-fit path, and a counter that only such devices
        # draw is no cell of the mesh.
        off_mesh = {n for n, g in geo.boxes.items()
                    if g.box is not None and g.box.num_chips != g.volume}
        in_mesh = {k for n, g in geo.boxes.items() if n not in off_mesh
                   for k in g.counters}
        outside = {k for n in off_mesh for k in geo.boxes[n].counters
                   } - in_mesh
        geo.boxes = {n: g for n, g in geo.boxes.items() if n not in off_mesh}
        geo.unit_counters = frozenset(
            (cs, c) for (p, cs, c), v in idx.capacity.items()
            if p == pool and v == 1 and (cs, c) not in outside)
        # Exclusive-placement geometry only: a unit DRAW against a
        # capacity-2 counter is shareable, so "some member dirty" would
        # not imply "unallocatable" and freeness-based scoring would
        # wrongly skip it. Such devices stay on the counter-fit path.
        geo.boxes = {n: g for n, g in geo.boxes.items()
                     if g.counters <= geo.unit_counters}
        geo.bit_of = {key: i
                      for i, key in enumerate(sorted(geo.unit_counters))}
        for g in geo.boxes.values():
            for key in g.counters:
                g.mask |= 1 << geo.bit_of[key]
        if geo.unit_counters:
            geo.whole = _GeoBox(
                name="", pool=pool, counters=geo.unit_counters,
                volume=len(geo.unit_counters),
                shape=f"pool[{len(geo.unit_counters)}]",
                mask=(1 << len(geo.unit_counters)) - 1)
        # Host topology from the published boxes (reporting/validation).
        # Mixed-rank boxes in one pool are malformed geometry: degrade
        # to counter-set math (the docstring's contract) rather than
        # crash every allocation on one bad pool.
        boxed = [g.box for g in geo.boxes.values() if g.box is not None]
        if boxed and geo.unit_counters and len(
                {b.ndims for b in boxed}) == 1:
            dims = tuple(
                max(b.origin[i] + b.shape[i] for b in boxed)
                for i in range(boxed[0].ndims))
            try:
                topo = Topology(dims=dims)
            except ValueError:
                topo = None
            if (topo is not None
                    and topo.num_chips == len(geo.unit_counters)
                    and all(topo.is_valid_subslice(b) for b in boxed)):
                geo.topology = topo
                if geo.whole is not None:
                    geo.whole.shape = topo.shape_str
                    geo.whole.box = Box(
                        origin=tuple(0 for _ in dims), shape=dims)
        geo.link()
        idx.geometry[pool] = geo
    for cand in idx.candidates:
        cand.key = (cand.pool, cand.device["name"])
        geo = idx.geometry.get(cand.pool)
        if geo is not None:
            cand.geo = geo.boxes.get(cand.device["name"])


# Kinds whose writes invalidate the usage index (the slice index keys on
# ResourceSlice alone; candidates additionally on DeviceClass).
_USAGE_KINDS = ("ResourceSlice", "ResourceClaim")
_CAND_KINDS = ("ResourceSlice", "DeviceClass")
_CAND_CACHE_MAX = 64
#: bounded memory for fragmentation-blocked claim records (the defrag
#: planner's work source); oldest evicted first, counted like any cache.
_BLOCKED_MAX = 256

STRATEGY_BEST_FIT = "best-fit"
STRATEGY_FIRST_FIT = "first-fit"


class Allocator:
    """Structured allocation with generation-stamped indexes and
    topology-aware placement (docs/performance.md, "Topology-aware
    allocation").

    Every index is stamped with the client's per-kind write generation
    (``FakeClient.kind_generation``) and reused until a write to a kind it
    depends on lands — the re-list/re-aggregate work that used to run per
    allocation now runs per *cluster change*. The usage index keys on the
    narrower STATUS-write generation (``kind_usage_generation``) when the
    client offers it: claim creates and annotation writes cannot change
    ``status.allocation``, so a 10k-claim arrival burst no longer costs a
    rescan per allocation. A client without generation stamps (e.g. the
    HTTP client) degrades to recomputing every time.

    ``strategy``: ``best-fit`` (default) scores every free placement —
    smallest viable free box first, tie-broken to destroy the fewest
    distinct free-box shapes — so mixed-size churn fragments the mesh as
    little as placement can help; ``first-fit`` is the pre-topology
    behavior (take the first counter-fitting candidate in publication
    order), kept as the bench baseline.

    Concurrency: instances serialize internally on ``mutex`` (reentrant)
    — ``allocate``/``release`` and the read surface the defrag planner
    consumes in the JAX package (``blocked_claims``) take it themselves,
    so concurrent actors (reallocator, CanaryProber, DefragPlanner) need
    no external scheduler lock and the critical section is exactly the
    index+pick+commit work, not the API reads around it
    (docs/performance.md, "Wire-path tail latency"). Legacy callers that
    still wrap calls in their own ``alloc_mutex`` compose safely when
    that mutex IS ``allocator.mutex`` (reentrant); the compiled-selector
    cache is process-global and separately locked.
    """

    def __init__(self, client: FakeClient,
                 metrics: Optional[AllocatorMetrics] = None,
                 strategy: str = STRATEGY_BEST_FIT):
        if strategy not in (STRATEGY_BEST_FIT, STRATEGY_FIRST_FIT):
            raise ValueError(f"unknown allocation strategy {strategy!r}")
        self.client = client
        # The scheduler mutex, owned by the allocator itself so every
        # component contends on ONE well-known lock scoped to the work
        # that truly needs it. Reentrant: a caller that already wraps
        # calls in this same mutex nests instead of deadlocking.
        self.mutex = sanitizer.new_lock("Allocator.mutex", reentrant=True)
        self.metrics = metrics or default_allocator_metrics()
        self.strategy = strategy
        self._gen_of = getattr(client, "kind_generation", None)
        self._ugen_of = getattr(client, "kind_usage_generation", None)
        self._slice_cache: Optional[tuple[tuple[int, ...], _SliceIndex]] = None
        # Detector cells for the caches below: they are swapped wholesale
        # on attributes (no dict to wrap), so reads/writes are noted
        # explicitly (sanitizer.note_read/note_write; race mode only).
        # The allocator's contract is ONE scheduler actor per client —
        # these cells are what prove a second, unserialized caller.
        self._cell_slices = sanitizer.new_cell("Allocator._slice_cache")
        self._cell_usage = sanitizer.new_cell("Allocator._usage_cache")
        self._cell_cands = sanitizer.new_cell("Allocator._cand_cache")
        self._cell_blocked = sanitizer.new_cell("Allocator.blocked")
        # usage-stamp → (consumed counters, (pool, device) → holder claim
        # key, per-pool dirty counter-key sets, per-pool dirty chip masks)
        self._usage_cache: Optional[tuple[
            tuple[int, ...],
            dict[tuple[str, str, str], int],
            dict[tuple[str, str], tuple[str, str, str]],
            dict[str, set],
            dict[str, int]]] = None
        # (device_class, node) → (stamp, class-filtered candidates)
        self._cand_cache: "OrderedDict[tuple[str, str], tuple]" = OrderedDict()
        #: fragmentation-blocked claims (capacity existed, no placement
        #: fit) — the defrag planner's work queue; bounded + counted.
        self.blocked: "OrderedDict[str, dict]" = OrderedDict()
        #: nominated placements: (pool, device) → uid of the blocked claim
        #: the defrag planner is clearing it for (guarded by ``mutex``).
        #: Every other claim is steered off them, as the Kubernetes
        #: scheduler holds a preemptor's nominated node: without it a
        #: victim moved out of one cleared placement lands in another
        #: one, and the preemptions chase each other. A nomination lives
        #: as long as its claim's ``blocked`` entry: every path that
        #: drops the entry drops it too, and the planner drops those of
        #: claims deleted or allocated behind its back.
        self.nominated: dict[tuple[str, str], str] = {}

    def _gens(self, *kinds: str) -> Optional[tuple[int, ...]]:
        return None if self._gen_of is None else self._gen_of(*kinds)

    def _usage_stamp(self) -> Optional[tuple[int, ...]]:
        """(ResourceSlice write gen, ResourceClaim STATUS-write gen).
        Falls back to the full claim write gen on clients without the
        status-only counter — strictly more invalidation, never less."""
        if self._gen_of is None:
            return None
        slice_gen = self._gen_of("ResourceSlice")
        if self._ugen_of is not None:
            return slice_gen + self._ugen_of("ResourceClaim")
        return slice_gen + self._gen_of("ResourceClaim")

    # -- indexes --------------------------------------------------------------

    def _slice_index(self) -> _SliceIndex:
        stamp = self._gens("ResourceSlice")
        sanitizer.note_read(self._cell_slices)
        cached = self._slice_cache
        if stamp is not None and cached is not None and cached[0] == stamp:
            self.metrics.hit("slices")
            return cached[1]
        self.metrics.miss("slices")
        idx = _SliceIndex()
        pool_nodes: dict[str, Optional[str]] = {}
        for s in self.client.list("ResourceSlice"):
            spec = s["spec"]
            pool = spec["pool"]["name"]
            node = spec.get("nodeName")
            pool_nodes.setdefault(pool, node)
            for dev in spec.get("devices", []):
                idx.by_pool_device[(pool, dev["name"])] = dev
                if _has_noschedule_taint(dev):
                    continue
                idx.candidates.append(_Candidate(
                    pool=pool,
                    driver=spec["driver"],
                    device=dev,
                    view=_device_view(dev),
                    node=node))
            for cs in spec.get("sharedCounters", []):
                for cname, cval in cs.get("counters", {}).items():
                    idx.capacity[(pool, cs["name"], cname)] = cval["value"]
        _build_geometry(idx, pool_nodes)
        if stamp is not None:
            sanitizer.note_write(self._cell_slices)
            self._slice_cache = (stamp, idx)
        return idx

    def _usage(self) -> tuple[Optional[tuple[int, ...]],
                              dict[tuple[str, str, str], int],
                              dict[tuple[str, str], tuple[str, str, str]],
                              dict[str, set],
                              dict[str, int]]:
        """(stamp, consumed counters, (pool, device) → holding claim's
        (uid, name, namespace), per-pool dirty counter keys, per-pool
        dirty chip masks) — mutable copies the caller may draw against;
        commit the mutated copies back with :meth:`_stamp_usage` after
        the allocation's own write."""
        stamp = self._usage_stamp()
        sanitizer.note_read(self._cell_usage)
        cached = self._usage_cache
        if stamp is not None and cached is not None and cached[0] == stamp:
            self.metrics.hit("usage")
            return (stamp, dict(cached[1]), dict(cached[2]),
                    {p: set(s) for p, s in cached[3].items()},
                    dict(cached[4]))
        self.metrics.miss("usage")
        idx = self._slice_index()
        consumed: dict[tuple[str, str, str], int] = {}
        allocated: dict[tuple[str, str], tuple[str, str, str]] = {}
        dirty: dict[str, set] = {}
        for claim in self.client.list("ResourceClaim"):
            status = claim.get("status") or {}
            results = (status.get("allocation") or {}).get(
                "devices", {}).get("results", [])
            if not results:
                continue
            m = claim.get("metadata") or {}
            holder = (m.get("uid", ""), m.get("name", ""),
                      m.get("namespace", ""))
            for r in results:
                allocated[(r["pool"], r["device"])] = holder
                dev = idx.by_pool_device.get((r["pool"], r["device"]))
                if not dev:
                    continue
                pool_dirty = dirty.setdefault(r["pool"], set())
                for cc in dev.get("consumesCounters", []):
                    for cname, cval in cc.get("counters", {}).items():
                        key = (r["pool"], cc["counterSet"], cname)
                        consumed[key] = consumed.get(key, 0) + cval["value"]
                        pool_dirty.add((cc["counterSet"], cname))
        masks = {pool: geo.dirty_mask(dirty.get(pool) or set())
                 for pool, geo in idx.geometry.items()}
        if stamp is not None:
            sanitizer.note_write(self._cell_usage)
            self._usage_cache = (stamp, dict(consumed), dict(allocated),
                                 {p: set(s) for p, s in dirty.items()},
                                 dict(masks))
        return stamp, consumed, allocated, dirty, masks

    def _stamp_usage(self, pre: Optional[tuple[int, ...]],
                     consumed: dict[tuple[str, str, str], int],
                     allocated: dict[tuple[str, str], tuple[str, str, str]],
                     dirty: dict[str, set],
                     masks: dict[str, int]) -> None:
        """Re-stamp the usage index after this allocator's own status
        write. Valid only when the sole status write since ``pre`` is ours
        (status generation advanced by exactly one, slices untouched); any
        concurrent writer voids the cache instead."""
        if pre is None:
            return
        post = self._usage_stamp()
        sanitizer.note_write(self._cell_usage)
        if post == (pre[0], pre[1] + 1):
            self._usage_cache = (post, dict(consumed), dict(allocated),
                                 {p: set(s) for p, s in dirty.items()},
                                 dict(masks))
        else:
            self._usage_cache = None

    # -- legacy aggregation views (kept for tests/introspection) --------------

    def _consumed_counters(self) -> dict[tuple[str, str, str], int]:
        """Aggregate counter draw of every device already allocated to any
        claim: (pool, counter_set, counter) → consumed units. Takes the
        (reentrant) mutex: ``_usage`` reads/writes the usage cache and
        assumes its callers hold the lock."""
        with self.mutex:
            return self._usage()[1]

    def _counter_capacity(self) -> dict[tuple[str, str, str], int]:
        return dict(self._slice_index().capacity)

    def _fits_counters(
        self,
        cand: _Candidate,
        consumed: dict[tuple[str, str, str], int],
        capacity: dict[tuple[str, str, str], int],
    ) -> bool:
        for cc in cand.device.get("consumesCounters", []):
            for cname, cval in cc.get("counters", {}).items():
                key = (cand.pool, cc["counterSet"], cname)
                cap = capacity.get(key)
                if cap is None:
                    return False  # consuming an unpublished counter
                if consumed.get(key, 0) + cval["value"] > cap:
                    return False
        return True

    @staticmethod
    def _draw(cand: _Candidate,
              consumed: dict[tuple[str, str, str], int],
              dirty: Optional[dict[str, set]] = None,
              masks: Optional[dict[str, int]] = None,
              geometry: Optional[dict[str, _PoolGeometry]] = None) -> None:
        pool_dirty = (dirty.setdefault(cand.pool, set())
                      if dirty is not None else None)
        add_mask = 0
        # Non-geometry candidates can still draw from unit (chip)
        # counters — e.g. a device mixing unit draws with a shareable
        # counter. Their bits MUST land in the pool mask too, or best-fit
        # (which trusts the mask alone for geometry freeness) could
        # double-book the chip before the next full usage rebuild.
        bit_of = None
        if (masks is not None and cand.geo is None
                and geometry is not None):
            geo = geometry.get(cand.pool)
            bit_of = geo.bit_of if geo is not None else None
        for cc in cand.device.get("consumesCounters", []):
            for cname, cval in cc.get("counters", {}).items():
                key = (cand.pool, cc["counterSet"], cname)
                consumed[key] = consumed.get(key, 0) + cval["value"]
                if pool_dirty is not None:
                    pool_dirty.add((cc["counterSet"], cname))
                if bit_of is not None:
                    b = bit_of.get((cc["counterSet"], cname))
                    if b is not None:
                        add_mask |= 1 << b
        if masks is not None:
            if cand.geo is not None:
                add_mask = cand.geo.mask
            if add_mask:
                masks[cand.pool] = masks.get(cand.pool, 0) | add_mask

    @staticmethod
    def _undraw(dev: dict[str, Any], pool: str,
                consumed: dict[tuple[str, str, str], int],
                dirty: dict[str, set],
                masks: dict[str, int],
                geo: Optional[_PoolGeometry]) -> None:
        """Inverse of :meth:`_draw` for one released device definition —
        the incremental half of :meth:`release`. A counter's mask bit
        clears only when its consumption actually reaches zero."""
        pool_dirty = dirty.get(pool)
        bit_of = geo.bit_of if geo is not None else {}
        clear = 0
        for cc in dev.get("consumesCounters", []):
            for cname, cval in cc.get("counters", {}).items():
                key = (pool, cc["counterSet"], cname)
                left = consumed.get(key, 0) - cval["value"]
                if left > 0:
                    consumed[key] = left
                else:
                    consumed.pop(key, None)
                    if pool_dirty is not None:
                        pool_dirty.discard((cc["counterSet"], cname))
                    b = bit_of.get((cc["counterSet"], cname))
                    if b is not None:
                        clear |= 1 << b
        if clear and pool in masks:
            masks[pool] &= ~clear

    # -- best-fit placement scoring (docs/performance.md) ---------------------

    def _pick_best_fit(
        self,
        cands: list[_Candidate],
        count: int,
        consumed: dict[tuple[str, str, str], int],
        allocated: dict[tuple[str, str], tuple[str, str, str]],
        capacity: dict[tuple[str, str, str], int],
        dirty: dict[str, set],
        masks: dict[str, int],
        geometry: dict[str, _PoolGeometry],
        holder: tuple[str, str, str],
        canary: bool = False,
    ) -> list[_Candidate]:
        """Pick up to ``count`` candidates by best-fit score — (smallest
        free enclosing box's volume, distinct free-box shapes destroyed),
        lower is better — re-scoring after every pick (each draw changes
        which boxes stay free).

        Two-pass per pick: the cheap primary key (walk the volume-sorted
        container chain to the first free one) is computed for every free
        candidate; the expensive tie-break (free-shape census over the
        overlap set) only for candidates tying on the primary. A
        placement nothing free encloses scores its own volume —
        allocating it breaks no larger free box, the best best-fit can
        do. Non-geometry candidates are used only when no geometry
        candidate fits, in publication order (first-fit semantics).

        ``canary``: last-resort placement for synthetic probe claims
        (``gpu.nvidia.com/canary``, docs/observability.md "Synthetic
        probing"): the fragmentation-minimizing primary key is kept, but
        ties resolve to the publication-LAST candidate (real claims take
        the first) — a canary never contends with a real claim for the
        same tie-broken chip, and on an idle node it drifts to the end
        of the pool."""
        picked: list[_Candidate] = []
        scanned = 0
        while len(picked) < count:
            # Pass 1: free geometry candidates with their enclosing
            # volume; non-geometry candidates collected as fallback.
            # Freeness/containment run on the usage index's per-pool chip
            # BITMASKS (one int op per box — maintained incrementally by
            # draw/undraw, never recomputed here); candidates carry their
            # geometry box and usage key, so the scan is attribute reads
            # and int ands.
            ties: list[tuple[_Candidate, _GeoBox]] = []
            best_enc: Optional[int] = None
            fallback: Optional[_Candidate] = None
            cur_pool: Optional[str] = None
            pool_mask = 0
            for cand in cands:
                if cand.key in allocated:
                    continue
                g = cand.geo
                if g is None:
                    if (fallback is None or canary) and self._fits_counters(
                            cand, consumed, capacity):
                        fallback = cand  # canary keeps the LAST fit
                    continue
                if cand.pool != cur_pool:
                    cur_pool = cand.pool
                    pool_mask = masks.get(cur_pool, 0)
                if g.mask & pool_mask:
                    continue  # not fully free == not allocatable (unit)
                scanned += 1
                enclosing = g.volume
                for container in g.containers:  # volume-ascending
                    if not container.mask & pool_mask:
                        enclosing = container.volume
                        break
                if best_enc is None or enclosing < best_enc:
                    best_enc = enclosing
                    ties = [(cand, g)]
                elif enclosing == best_enc:
                    ties.append((cand, g))
            if not ties:
                if fallback is None:
                    break
                cand = fallback
            elif len(ties) == 1:
                cand = ties[0][0]
            elif canary:
                # Last-resort: lose every tie to real traffic — skip the
                # shape census and take the publication-last placement.
                cand = ties[-1][0]
            else:
                # Pass 2: among primary-key ties, destroy the fewest
                # distinct free-box shapes (publication order last).
                # Per-shape mask groups short-circuit at the first free
                # member of each shape.
                cand = ties[0][0]
                best_destroyed: Optional[int] = None
                for c, g in ties:
                    pm = masks.get(c.pool, 0)
                    destroyed = 0
                    for group in g.overlap_groups:
                        for m_ in group:
                            if not m_ & pm:
                                destroyed += 1
                                break
                    if best_destroyed is None or destroyed < best_destroyed:
                        best_destroyed, cand = destroyed, c
                        if destroyed == 0:
                            break
            picked.append(cand)
            self._draw(cand, consumed, dirty, masks, geometry)
            allocated[cand.key] = holder
        if scanned:
            self.metrics.candidates_scanned_total.inc(
                scanned, strategy=STRATEGY_BEST_FIT)
        return picked

    def _pick_first_fit(
        self,
        cands: list[_Candidate],
        count: int,
        consumed: dict[tuple[str, str, str], int],
        allocated: dict[tuple[str, str], tuple[str, str, str]],
        capacity: dict[tuple[str, str, str], int],
        dirty: dict[str, set],
        masks: dict[str, int],
        geometry: dict[str, _PoolGeometry],
        holder: tuple[str, str, str],
        canary: bool = False,
    ) -> list[_Candidate]:
        picked: list[_Candidate] = []
        scanned = 0
        # Canary claims are last-resort placements under BOTH strategies:
        # first-fit simply scans from the publication end backwards.
        for cand in (reversed(cands) if canary else cands):
            scanned += 1
            if cand.key in allocated or not self._fits_counters(
                    cand, consumed, capacity):
                continue
            picked.append(cand)
            self._draw(cand, consumed, dirty, masks, geometry)
            allocated[cand.key] = holder
            if len(picked) == count:
                break
        if scanned:
            self.metrics.candidates_scanned_total.inc(
                scanned, strategy=STRATEGY_FIRST_FIT)
        return picked

    # -- allocation ---------------------------------------------------------

    def _class_candidates(self, device_class: Optional[str],
                          node: Optional[str]) -> list[_Candidate]:
        """Candidates surviving node pinning + DeviceClass selectors —
        cached per (class, node) until a ResourceSlice or DeviceClass
        write lands. Request selectors are applied by the caller (they
        vary per claim)."""
        stamp = self._gens(*_CAND_KINDS)
        key = (device_class or "", node or "")
        sanitizer.note_read(self._cell_cands)
        ent = self._cand_cache.get(key)
        if stamp is not None and ent is not None and ent[0] == stamp:
            self.metrics.hit("candidates")
            sanitizer.note_write(self._cell_cands)  # LRU reorder mutates
            self._cand_cache.move_to_end(key)
            return ent[1]
        self.metrics.miss("candidates")
        class_selectors: list[dict[str, Any]] = []
        if device_class:
            dc = self.client.try_get("DeviceClass", device_class)
            if dc is not None:
                class_selectors = (dc.get("spec") or {}).get("selectors", [])
        out: list[_Candidate] = []
        for cand in self._slice_index().candidates:
            # Node pinning: the scheduler allocates from the slices of the
            # node the pod lands on (ResourceSlice.spec.nodeName affinity).
            if node is not None and cand.node not in (None, "", node):
                continue
            ok = True
            for sel in class_selectors:
                expr = (sel.get("cel") or {}).get("expression", "")
                if expr and not eval_selector(expr, cand.view):
                    ok = False
                    break
            if ok:
                out.append(cand)
        if stamp is not None:
            sanitizer.note_write(self._cell_cands)
            self._cand_cache[key] = (stamp, out)
            while len(self._cand_cache) > _CAND_CACHE_MAX:
                self._cand_cache.popitem(last=False)
                self.metrics.evict("candidates")
        return out

    def _candidates(self, device_class: Optional[str],
                    selectors: list[dict[str, Any]],
                    node: Optional[str] = None) -> list[_Candidate]:
        out: list[_Candidate] = []
        for cand in self._class_candidates(device_class, node):
            ok = True
            for sel in selectors:
                expr = (sel.get("cel") or {}).get("expression", "")
                if expr and not eval_selector(expr, cand.view):
                    ok = False
                    break
            if ok:
                out.append(cand)
        return out

    def allocate(self, claim: Obj,
                 reserved_for: Optional[list[dict[str, str]]] = None,
                 node: Optional[str] = None,
                 avoid: Optional[Iterable[tuple[str, str]]] = None) -> Obj:
        """Allocate every request of the claim; writes and returns the
        updated claim. Raises AllocationError when unsatisfiable.
        ``node`` restricts candidates to that node's slices (the scheduler's
        node-placement coupling). ``avoid`` excludes the named
        (pool, device) placements AND every placement overlapping their
        chips — the defrag planner's steering input: a preempted victim
        must not be re-placed back into the hole being cleared
        (docs/performance.md, "Topology-aware allocation")."""
        # The "allocate" phase of a claim trace: joins the caller's active
        # span or the claim's propagated traceparent (docs/observability.md).
        with tracing.span_for_object(
                "allocate", claim,
                attributes={"claim": claim["metadata"].get("name", "")}):
            # Entry read OUTSIDE the scheduler mutex: the fresh GET is
            # pure API traffic and used to sit inside every caller's
            # alloc_mutex span, stretching the section every contender
            # waits on. A write racing the read surfaces as the same
            # ConflictError a stale caller-supplied claim always risked.
            fresh = self.client.get(
                "ResourceClaim", claim["metadata"]["name"],
                claim["metadata"].get("namespace", ""))
            with self.mutex:
                return self._allocate_traced(fresh, reserved_for, node,
                                             avoid)

    def _avoid_filter(self, cands: list[_Candidate],
                      avoid: Iterable[tuple[str, str]],
                      idx: _SliceIndex) -> list[_Candidate]:
        keys = set(avoid)
        counters: dict[str, set] = {}
        for pool, dev in keys:
            geo = idx.geometry.get(pool)
            g = geo.boxes.get(dev) if geo is not None else None
            if g is not None:
                counters.setdefault(pool, set()).update(g.counters)
        out = []
        for cand in cands:
            if (cand.pool, cand.name) in keys:
                continue
            ac = counters.get(cand.pool)
            if ac:
                geo = idx.geometry.get(cand.pool)
                g = geo.boxes.get(cand.name) if geo is not None else None
                if g is not None and not g.counters.isdisjoint(ac):
                    continue
            out.append(cand)
        return out

    def _shortfall_is_fragmentation(
        self, cands: list[_Candidate], count: int, picked: int,
        idx: _SliceIndex, masks: dict[str, int],
    ) -> bool:
        """Whether an ExactCount shortfall happened WHILE aggregate free
        capacity covered the request — the admission failure defrag can
        fix, as opposed to a genuinely full fleet."""
        if not cands:
            return False
        min_vol = None
        pools = set()
        for cand in cands:
            if cand.geo is None:
                continue
            pools.add(cand.pool)
            if min_vol is None or cand.geo.volume < min_vol:
                min_vol = cand.geo.volume
        if min_vol is None or not pools:
            return False
        needed = (count - picked) * min_vol
        free = sum(idx.geometry[p].free_units(masks.get(p, 0))
                   for p in pools)
        return free >= needed

    def _note_blocked(self, fresh: Obj, req_name: str, count: int,
                      cands: list[_Candidate], node: Optional[str],
                      idx: _SliceIndex) -> None:
        m = fresh.get("metadata") or {}
        uid = m.get("uid", "")
        shapes: set[str] = set()
        chips = 0
        for cand in cands:
            geo = idx.geometry.get(cand.pool)
            g = geo.boxes.get(cand.name) if geo is not None else None
            if g is not None:
                shapes.add(g.shape)
                chips = max(chips, g.volume)
        sanitizer.note_write(self._cell_blocked)
        self.blocked[uid] = {
            "uid": uid,
            "name": m.get("name", ""),
            "namespace": m.get("namespace", ""),
            "request": req_name,
            "count": count,
            "chips": chips * count,
            "shapes": sorted(shapes),
            "node": node,
        }
        self.blocked.move_to_end(uid)
        while len(self.blocked) > _BLOCKED_MAX:
            self.drop_nominations(self.blocked.popitem(last=False)[0])
            self.metrics.evict("blocked")

    def blocked_claims(self) -> list[dict]:
        """Fragmentation-blocked claims, oldest first — the defrag
        planner's work source (kubeletplugin/remediation.py)."""
        with self.mutex:
            sanitizer.note_read(self._cell_blocked)
            return list(self.blocked.values())

    def _allocate_traced(self, fresh: Obj,
                         reserved_for: Optional[list[dict[str, str]]],
                         node: Optional[str],
                         avoid: Optional[Iterable[tuple[str, str]]]) -> Obj:
        """Caller holds ``mutex`` and has already re-read the claim."""
        status = fresh.get("status") or {}
        if status.get("allocation"):
            sanitizer.note_write(self._cell_blocked)
            self.blocked.pop(fresh["metadata"].get("uid", ""), None)
            self.drop_nominations(fresh["metadata"].get("uid", ""))
            return fresh  # idempotent

        idx = self._slice_index()
        capacity = idx.capacity
        # Devices already held by *other* claims are not re-allocatable
        # (full-device exclusivity; sharing happens at the claim level).
        pre, consumed, allocated, dirty, masks = self._usage()
        m = fresh.get("metadata") or {}
        holder = (m.get("uid", ""), m.get("name", ""), m.get("namespace", ""))
        # Synthetic probe claims place last-resort (docs/observability.md,
        # "Synthetic probing"): same fragmentation-minimizing score, ties
        # lost to real traffic.
        canary = ANN_CANARY in (m.get("annotations") or {})

        results: list[dict[str, Any]] = []
        for req in claim_requests(fresh):
            name = req.get("name", "")
            exact = req.get("exactly") or req  # tolerate flat requests
            mode = exact.get("allocationMode", "ExactCount")
            count = int(exact.get("count", 1))
            cands = self._candidates(
                exact.get("deviceClassName"), exact.get("selectors", []),
                node=node)
            if avoid:
                cands = self._avoid_filter(cands, avoid, idx)
            others = [k for k, uid in self.nominated.items()
                      if uid != holder[0]]
            if others:
                cands = self._avoid_filter(cands, others, idx)
            if mode == "All":
                # DRA "All" semantics: every matching device must be
                # allocatable, or the claim fails — a partial subset is
                # never handed out. Placement scoring has no choices to
                # make here.
                picked = []
                for cand in cands:
                    if ((cand.pool, cand.name) in allocated
                            or not self._fits_counters(cand, consumed,
                                                       capacity)):
                        self.metrics.allocations_total.inc(
                            outcome="unsatisfiable")
                        raise AllocationError(
                            f"request {name!r}: allocationMode=All but "
                            f"device {cand.name} (pool {cand.pool}) is "
                            "unavailable")
                    picked.append(cand)
                    self._draw(cand, consumed, dirty, masks, idx.geometry)
                    allocated[cand.key] = holder
                if not picked:
                    self.metrics.allocations_total.inc(
                        outcome="unsatisfiable")
                    raise AllocationError(
                        f"request {name!r}: no devices match")
            else:
                if self.strategy == STRATEGY_BEST_FIT:
                    picked = self._pick_best_fit(
                        cands, count, consumed, allocated, capacity,
                        dirty, masks, idx.geometry, holder, canary=canary)
                else:
                    picked = self._pick_first_fit(
                        cands, count, consumed, allocated, capacity,
                        dirty, masks, idx.geometry, holder, canary=canary)
                if len(picked) < count:
                    fragmented = self._shortfall_is_fragmentation(
                        cands, count, len(picked), idx, masks)
                    if fragmented:
                        self._note_blocked(fresh, name, count, cands,
                                           node, idx)
                    self.metrics.allocations_total.inc(
                        outcome="fragmented" if fragmented
                        else "unsatisfiable")
                    raise AllocationError(
                        f"request {name!r}: want {count} devices, "
                        f"only {len(picked)} allocatable"
                        + (" (free capacity exists but is fragmented)"
                           if fragmented else ""))
            for cand in picked:
                results.append({
                    "request": name,
                    "driver": cand.driver,
                    "pool": cand.pool,
                    "device": cand.name,
                })

        # Allocation config: DeviceClass config entries first, then claim
        # config (precedence order, device_state.go:1410-1482).
        alloc_config: list[dict[str, Any]] = []
        for req in claim_requests(fresh):
            exact = req.get("exactly") or req
            dc_name = exact.get("deviceClassName")
            if not dc_name:
                continue
            dc = self.client.try_get("DeviceClass", dc_name)
            for cfg in ((dc or {}).get("spec") or {}).get("config", []):
                alloc_config.append({
                    "source": "FromClass",
                    "requests": [req.get("name", "")],
                    **cfg,
                })
        for cfg in (fresh.get("spec") or {}).get("devices", {}).get("config", []):
            alloc_config.append({"source": "FromClaim", **cfg})

        fresh.setdefault("status", {})["allocation"] = {
            "devices": {"results": results, "config": alloc_config},
        }
        if reserved_for:
            fresh["status"]["reservedFor"] = reserved_for
        updated = self.client.update_status(fresh)
        # Our own write is the one invalidation we can absorb in place:
        # the drawn-down copies ARE the post-write usage.
        self._stamp_usage(pre, consumed, allocated, dirty, masks)
        self.metrics.allocations_total.inc(outcome="success")
        sanitizer.note_write(self._cell_blocked)
        self.blocked.pop(holder[0], None)
        self.drop_nominations(holder[0])
        self._update_fragmentation(
            idx, masks, {r["pool"] for r in results})
        return updated

    def nominate(self, pool: str, device: str, uid: str) -> None:
        """Hold the placement ``(pool, device)`` for the blocked claim
        ``uid`` (its previous nomination dropped) until that claim is
        allocated or :meth:`drop_nominations` releases it."""
        with self.mutex:
            self.drop_nominations(uid)
            self.nominated[(pool, device)] = uid

    def drop_nominations(self, uid: str) -> None:
        """Release every placement held for the claim ``uid``."""
        with self.mutex:
            for key in [k for k, v in self.nominated.items() if v == uid]:
                del self.nominated[key]

    # -- fragmentation accounting (docs/performance.md) -----------------------

    def _utilization(self, idx: _SliceIndex, geo: _PoolGeometry,
                     mask: int) -> float:
        """Drawn ÷ healthy chips for one pool: the occupancy number
        operators (and the canary/usage dashboards) read directly.
        Healthy = unit-volume boxes whose published device carries no
        NoSchedule/NoExecute taint — a cordoned or health-tainted chip
        leaves the denominator AND the numerator (claims still holding
        it are mid-drain, not serving capacity)."""
        healthy = 0
        healthy_mask = 0
        for name, g in geo.boxes.items():
            if g.volume != 1:
                continue
            dev = idx.by_pool_device.get((geo.pool, name))
            if dev is not None and _has_noschedule_taint(dev):
                continue
            healthy += 1
            healthy_mask |= g.mask
        if healthy == 0:
            return 0.0
        return round((mask & healthy_mask).bit_count() / healthy, 4)

    def _update_fragmentation(self, idx: _SliceIndex,
                              masks: dict[str, int],
                              pools: Iterable[str]) -> None:
        for pool in pools:
            geo = idx.geometry.get(pool)
            if geo is None:
                continue
            mask = masks.get(pool, 0)
            row = geo.fragmentation(mask)
            self.metrics.fragmentation.set(
                row["fragmentation"], node=row["node"], pool=pool)
            self.metrics.utilization.set(
                self._utilization(idx, geo, mask),
                node=row["node"], pool=pool)

    def fragmentation_report(self,
                             update_gauge: bool = True) -> list[dict]:
        """Per-pool fragmentation + utilization rows (free chips, largest
        allocatable box, the gauge values) — the debug and test surface;
        optionally refreshes ``gpu_dra_allocator_fragmentation`` and
        ``gpu_dra_allocator_utilization`` for every pool."""
        with self.mutex:
            idx = self._slice_index()
            _stamp, _consumed, _allocated, _dirty, masks = self._usage()
            rows = []
            for pool in sorted(idx.geometry):
                geo = idx.geometry[pool]
                mask = masks.get(pool, 0)
                row = geo.fragmentation(mask)
                row["utilization"] = self._utilization(idx, geo, mask)
                rows.append(row)
                if update_gauge:
                    self.metrics.fragmentation.set(
                        row["fragmentation"], node=row["node"], pool=pool)
                    self.metrics.utilization.set(
                        row["utilization"], node=row["node"], pool=pool)
            return rows

    def placement_options(self, claim: Obj,
                          node: Optional[str] = None) -> list[dict]:
        """Every geometry placement that could host the claim's
        ExactCount requests, with its current occupants — the defrag
        planner's target menu. Each row: request, pool, device, volume,
        victims (holding claims as uid, name, namespace, the chips they
        hold and the shapes of the boxes they hold, deduplicated), and
        victim_chips (total chips those claims hold anywhere — the
        drain-priority weight preemption scoring minimizes)."""
        with self.mutex:
            idx = self._slice_index()
            _stamp, _consumed, allocated, _dirty, _masks = self._usage()
            holder_chips: dict[tuple[str, str, str], int] = {}
            holder_shapes: dict[tuple[str, str, str], set[str]] = {}
            for (pool, dev), h in allocated.items():
                geo = idx.geometry.get(pool)
                g = geo.boxes.get(dev) if geo is not None else None
                holder_chips[h] = holder_chips.get(h, 0) + (
                    g.volume if g is not None else 1)
                if g is not None:
                    holder_shapes.setdefault(h, set()).add(g.shape)
            out: list[dict] = []
            for req in claim_requests(claim):
                exact = req.get("exactly") or req
                if exact.get("allocationMode", "ExactCount") != "ExactCount":
                    continue
                cands = self._candidates(
                    exact.get("deviceClassName"),
                    exact.get("selectors", []), node=node)
                for cand in cands:
                    geo = idx.geometry.get(cand.pool)
                    g = geo.boxes.get(cand.name) if geo is not None else None
                    if g is None:
                        continue
                    victims: dict[tuple[str, str, str], None] = {}
                    for o in (g, *g.overlapping):
                        h = allocated.get((cand.pool, o.name))
                        if h is not None:
                            victims[h] = None
                    out.append({
                        "request": req.get("name", ""),
                        "pool": cand.pool,
                        "device": cand.name,
                        "volume": g.volume,
                        "victims": [
                            {"uid": h[0], "name": h[1], "namespace": h[2],
                             "chips": holder_chips.get(h, 0),
                             "shapes": sorted(holder_shapes.get(h, ()))}
                            for h in victims],
                        "victim_chips": sum(holder_chips.get(h, 0)
                                            for h in victims),
                    })
            return out

    # -- extended resources (KEP-5004) --------------------------------------

    def extended_resource_classes(self) -> dict[str, str]:
        """Extended-resource name → DeviceClass name, for every class that
        advertises the mapping via ``spec.extendedResourceName`` (the GPU
        chart's ``deviceclasses.yaml``, as the reference's
        ``deviceclass-gpu.yaml`` maps ``nvidia.com/gpu``). First advertiser
        by class name wins, matching the scheduler's deterministic pick."""
        out: dict[str, str] = {}
        for dc in sorted(self.client.list("DeviceClass"),
                         key=lambda d: d["metadata"]["name"]):
            rname = (dc.get("spec") or {}).get("extendedResourceName", "")
            if rname:
                out.setdefault(rname, dc["metadata"]["name"])
        return out

    def synthesize_extended_claims(self, pod: Obj) -> list[Obj]:
        """The scheduler side of extended-resource DRA (KEP-5004, the
        reference's ``tests/bats/test_gpu_extres.bats``): a pod requesting
        ``nvidia.com/gpu: N`` in container limits, with no ResourceClaim of
        its own, gets one synthesized against the DeviceClass advertising
        the mapping. Idempotent per pod UID; returns the (possibly
        pre-existing) implicit claims."""
        ns = pod["metadata"].get("namespace", "")
        mapping = self.extended_resource_classes()
        totals: dict[str, int] = {}
        for ctr in (pod.get("spec") or {}).get("containers", []):
            res = ctr.get("resources") or {}
            # The API server makes limits equal requests for extended
            # resources; the union tolerates specs carrying only one.
            merged = {**(res.get("requests") or {}),
                      **(res.get("limits") or {})}
            for rname, qty in merged.items():
                if rname in mapping:
                    totals[rname] = (totals.get(rname, 0)
                                     + _parse_quantity(str(qty)))
        if not totals:
            return []
        claim_name = pod["metadata"]["name"] + "-extended-resources"
        pod_uid = pod["metadata"].get("uid", "")
        existing = self.client.try_get("ResourceClaim", claim_name, ns)
        if existing is not None:
            owners = existing["metadata"].get("ownerReferences") or [{}]
            is_implicit = (ANN_EXTENDED_RESOURCE_NAMES
                           in (existing["metadata"].get("annotations") or {})
                           and owners[0].get("kind") == "Pod")
            if not is_implicit:
                # A user's claim that happens to carry the implicit name:
                # never destroy an object this path does not own.
                raise AllocationError(
                    f"cannot synthesize extended-resource claim: "
                    f"{ns}/{claim_name} exists and is not an implicit "
                    "claim")
            if owners[0].get("uid", "") == pod_uid:
                return [existing]
            # Same pod name, another incarnation: the stale claim belongs
            # to a dead pod (its ownerRef GC would delete it under this
            # one, and its counts may differ). Replace it.
            self.client.delete("ResourceClaim", claim_name, ns)
        claim = {
            "apiVersion": "resource.k8s.io/v1",
            "kind": "ResourceClaim",
            "metadata": {
                "name": claim_name,
                "namespace": ns,
                "annotations": {
                    ANN_EXTENDED_RESOURCE_NAMES: ",".join(sorted(totals)),
                },
                "ownerReferences": [{
                    "apiVersion": "v1", "kind": "Pod",
                    "name": pod["metadata"]["name"],
                    "uid": pod_uid,
                }],
            },
            "spec": {"devices": {"requests": [
                {"name": f"extres-{i}",
                 "exactly": {"deviceClassName": mapping[rname],
                             "allocationMode": "ExactCount",
                             "count": count}}
                for i, (rname, count) in enumerate(sorted(totals.items()))
            ]}},
        }
        return [self.client.create(claim)]

    def release(self, claim: Obj) -> Obj:
        """Drop the claim's allocation and update the usage index IN
        PLACE: the released draws are subtracted from the cached
        consumed/dirty state and the cache re-stamped, so a
        release-heavy churn phase no longer pays a full usage rescan on
        every subsequent allocation (the pre-topology behavior relied on
        generation invalidation alone)."""
        # Entry read outside the scheduler mutex, as in allocate().
        fresh = self.client.get(
            "ResourceClaim", claim["metadata"]["name"],
            claim["metadata"].get("namespace", ""))
        with self.mutex:
            status = fresh.get("status") or {}
            results = (status.get("allocation") or {}).get(
                "devices", {}).get("results", [])
            # On a generation-less client (the HTTP path) there is no
            # cache to keep warm: _stamp_usage would discard the work, so
            # skip the index build entirely — the degraded path recomputes
            # per allocation anyway.
            incremental = bool(results) and self._gen_of is not None
            idx = pre = consumed = allocated = dirty = masks = None
            if incremental:
                idx = self._slice_index()
                pre, consumed, allocated, dirty, masks = self._usage()
                for r in results:
                    allocated.pop((r["pool"], r["device"]), None)
                    dev = idx.by_pool_device.get((r["pool"], r["device"]))
                    if dev is not None:
                        self._undraw(dev, r["pool"], consumed, dirty,
                                     masks, idx.geometry.get(r["pool"]))
            status.pop("allocation", None)
            status.pop("reservedFor", None)
            fresh["status"] = status
            updated = self.client.update_status(fresh)
            if incremental:
                self._stamp_usage(pre, consumed, allocated, dirty, masks)
                self._update_fragmentation(
                    idx, masks, {r["pool"] for r in results})
            return updated
