"""The numerics-policy tree: per-op-class format/rounding/impl selection.

A :class:`Policy` answers, for every quantizable op site in the system,
the question the paper poses per scalar op: *which FP8 format, which
rounding mode, which implementation of the integer datapath?*  One frozen
:class:`OpPolicy` per op class:

  ============== =====================================================
  op class        what it governs
  ============== =====================================================
  ``matmul``       the activation side of quantized matmuls
  ``weights``      the weight side (STE training and static inference)
  ``attention_qk`` the integer-domain QK^T of paged decode attention
  ``attention_pv`` the P·V stage of paged decode attention (its ``fmt``
                   must match ``attention_qk`` — one KV-cache storage
                   format; ``mode``/``impl`` are reserved until the
                   kernel grows a distinct PV rounding stage)
  ``kv_write``     f32 -> code KV-cache writes (token and prefill)
  ``kv_rescale``   code -> code page-scale rescales (prefill splice)
  ``elementwise``  LNS elementwise chains (SwiGLU gating, rsqrt, ...)
  ============== =====================================================

``fmt="none"`` means "leave this op class in full precision".  Glob-style
per-site :class:`Override` entries (e.g. ``("matmul", "blocks.*.attn.wq",
OpPolicy(...))``) specialize individual call sites; the *last* matching
override wins, so presets can layer a broad rule then pinpoint exceptions.

Validation happens at construction: the paper's LNS product is
single-format, so a ``matmul`` policy pinning ``impl="lns"`` with an
activation format different from the weight format at the same site is
rejected here — with an error naming the op site — instead of deep inside
kernel tracing (the old failure mode of ``_ste_qmatmul``).

The registry maps preset names (``train_bf16``, ``serve_fp8_paged``, ...)
to policies.  Policies serialize to/from JSON (:meth:`Policy.to_json` /
:meth:`Policy.from_json`) so a serving config can be shipped as data.

This is the PyTorch port's copy of ``repro.numerics.policy`` (pure
Python), with the same presets; ``tests/test_torch_model.py`` pins every
preset equal to the reference's.  The legacy ``QuantConfig`` bridge is
not ported: the port has no ``QuantConfig``.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import json
from typing import Any, Dict, Iterable, Mapping, Optional, Tuple, Union

FP8_FORMATS = ("e4m3", "e5m2")
ALLOWED_FMTS = FP8_FORMATS + ("none",)
# Table-2/3 deterministic modes + the f32-encoder/stochastic-carry mode.
ALLOWED_MODES = ("rne", "rna", "rnz", "rz", "ru", "rd", "faithful",
                 "stochastic")
ALLOWED_IMPLS = {
    "matmul": ("auto", "xla", "lns", "lns_loop", "fused_dequant"),
    "weights": ("auto",),
    "attention_qk": ("auto", "kernel", "ref"),
    "attention_pv": ("auto", "kernel", "ref"),
    "kv_write": ("auto",),
    "kv_rescale": ("auto",),
    "elementwise": ("auto", "pallas", "ref"),
}
ALLOWED_ACCUMS = ("f32", "bf16")

OP_CLASSES = ("matmul", "weights", "attention_qk", "attention_pv",
              "kv_write", "kv_rescale", "elementwise")

# The paper's single-format LNS product: these matmul impls add operand
# codes directly, so both operands must share one format.
SINGLE_FORMAT_IMPLS = ("lns", "lns_loop")

# Tensor-parallel placement roles a policy may pin per weight site
# (consumed by parallel.sharding.serve_param_pspecs).  Serving TP is
# concatenation-only — roles shard an output/vocab dim or replicate; no
# role introduces a cross-shard sum, so bit-identity survives any choice.
SHARD_ROLES = ("columns", "rows", "replicate")


@dataclasses.dataclass(frozen=True)
class OpPolicy:
    """Numeric policy of one op class (or one overridden site).

    ``fmt``: ``"e4m3"`` | ``"e5m2"`` | ``"none"`` (= full precision).
    ``mode``: rounding mode (Table 2/3 names, plus ``"stochastic"``).
    ``impl``: kernel implementation; ``"auto"`` defers to
    ``kernels.autotune`` / the op's backend-aware default.
    ``accum``: accumulation/compute dtype of the surrounding reduction.
    """

    fmt: str = "none"
    mode: str = "rne"
    impl: str = "auto"
    accum: str = "f32"

    def __post_init__(self):
        if self.fmt not in ALLOWED_FMTS:
            raise ValueError(
                f"OpPolicy.fmt must be one of {ALLOWED_FMTS}, got {self.fmt!r}"
            )
        if self.mode not in ALLOWED_MODES:
            raise ValueError(
                f"OpPolicy.mode must be one of {ALLOWED_MODES}, "
                f"got {self.mode!r}"
            )
        if self.accum not in ALLOWED_ACCUMS:
            raise ValueError(
                f"OpPolicy.accum must be one of {ALLOWED_ACCUMS}, "
                f"got {self.accum!r}"
            )

    @property
    def quantized(self) -> bool:
        return self.fmt != "none"

    def replace(self, **kw) -> "OpPolicy":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> Dict[str, str]:
        return {"fmt": self.fmt, "mode": self.mode, "impl": self.impl,
                "accum": self.accum}

    @classmethod
    def from_dict(cls, d: Mapping[str, str]) -> "OpPolicy":
        return cls(**dict(d))


@dataclasses.dataclass(frozen=True)
class Override:
    """Per-site specialization: ``op`` class + glob ``site`` pattern.

    Site names mirror the parameter-tree paths the model layers report,
    e.g. ``"blocks.0.attn.wq"`` (the sublayer index within the scan
    pattern is static; the scanned block index is the wildcard), so
    patterns look like ``"blocks.*.attn.wq"`` or ``"prefix.*"``.
    """

    op: str
    site: str
    policy: OpPolicy

    def __post_init__(self):
        if self.op not in OP_CLASSES:
            raise ValueError(
                f"Override.op must be one of {OP_CLASSES}, got {self.op!r}"
            )

    def matches(self, op: str, site: str) -> bool:
        return op == self.op and fnmatch.fnmatchcase(site, self.site)

    def to_dict(self) -> Dict[str, Any]:
        return {"op": self.op, "site": self.site,
                "policy": self.policy.to_dict()}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "Override":
        return cls(op=d["op"], site=d["site"],
                   policy=OpPolicy.from_dict(d["policy"]))


def _as_overrides(v) -> Tuple[Override, ...]:
    out = []
    for item in v or ():
        if isinstance(item, Override):
            out.append(item)
        elif isinstance(item, (tuple, list)) and len(item) == 3:
            op, site, pol = item
            if isinstance(pol, Mapping):
                pol = OpPolicy.from_dict(pol)
            out.append(Override(op=op, site=site, policy=pol))
        else:
            raise TypeError(f"bad override entry {item!r}")
    return tuple(out)


def _as_shard_specs(v) -> Tuple[Tuple[str, str], ...]:
    out = []
    for item in v or ():
        if isinstance(item, (tuple, list)) and len(item) == 2:
            site, role = item
            out.append((str(site), str(role)))
        else:
            raise TypeError(f"bad shard_specs entry {item!r}; "
                            "expected (site_glob, role)")
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class Policy:
    """The full numerics policy: one :class:`OpPolicy` per op class,
    plus per-site overrides and the static-weights switch.

    Frozen and hashable, so it can ride in :class:`ModelConfig` and key
    caches.  Construction validates cross-field invariants (see module
    docstring); :meth:`resolve` answers per-site lookups.
    """

    name: str = "custom"
    matmul: OpPolicy = OpPolicy()
    weights: OpPolicy = OpPolicy()
    attention_qk: OpPolicy = OpPolicy()
    attention_pv: OpPolicy = OpPolicy()
    kv_write: OpPolicy = OpPolicy()
    kv_rescale: OpPolicy = OpPolicy()
    elementwise: OpPolicy = OpPolicy()
    static_weights: bool = False
    overrides: Tuple[Override, ...] = ()
    # Per-site tensor-parallel placement: (site glob, SHARD_ROLES entry)
    # pairs, last match winning.  Empty means "use the name-based serving
    # defaults" (parallel.sharding.serve_param_pspecs).
    shard_specs: Tuple[Tuple[str, str], ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "overrides", _as_overrides(self.overrides))
        object.__setattr__(self, "shard_specs",
                           _as_shard_specs(self.shard_specs))
        for site, role in self.shard_specs:
            if role not in SHARD_ROLES:
                raise ValueError(
                    f"policy {self.name!r}: shard_specs site {site!r} has "
                    f"role {role!r}; allowed: {SHARD_ROLES}"
                )
        for ov in self.overrides:
            allowed = ALLOWED_IMPLS[ov.op]
            if ov.policy.impl not in allowed:
                raise ValueError(
                    f"policy {self.name!r}: override for op-site "
                    f"{ov.op}:{ov.site!r} has impl={ov.policy.impl!r}; "
                    f"allowed: {allowed}"
                )
        for op in OP_CLASSES:
            pol = getattr(self, op)
            if pol.impl not in ALLOWED_IMPLS[op]:
                raise ValueError(
                    f"policy {self.name!r}: op class {op!r} has "
                    f"impl={pol.impl!r}; allowed: {ALLOWED_IMPLS[op]}"
                )
        if self.static_weights and not self.weights.quantized:
            raise ValueError(
                f"policy {self.name!r}: static_weights=True needs a weight "
                "format (weights.fmt is 'none')"
            )
        if self.matmul.quantized and not self.weights.quantized:
            raise ValueError(
                f"policy {self.name!r}: quantized matmul activations "
                f"(matmul.fmt={self.matmul.fmt!r}) need quantized weights "
                "(weights.fmt is 'none')"
            )
        if self.attention_pv.fmt != self.attention_qk.fmt:
            raise ValueError(
                f"policy {self.name!r}: attention_pv.fmt "
                f"({self.attention_pv.fmt!r}) must match attention_qk.fmt "
                f"({self.attention_qk.fmt!r}) — the paged decode kernel "
                "reads K and V pages in the one format the KV cache stores"
            )
        self._check_single_format("matmul", "<base>", self.matmul)
        for ov in self.overrides:
            # resolve the opposite side treating the override pattern
            # itself as the site name; glob-vs-glob corners this static
            # check cannot decide are coerced single-format at run time
            # (numerics.matmul / static_matmul_2d), never a tracing crash
            if ov.op == "matmul":
                wfmt = self.resolve("weights", ov.site).fmt
                self._check_single_format("matmul", ov.site, ov.policy, wfmt)
            elif ov.op == "weights":
                mp = self.resolve("matmul", ov.site)
                self._check_single_format("matmul", ov.site, mp,
                                          ov.policy.fmt)

    def _check_single_format(self, op: str, site: str, pol: OpPolicy,
                             wfmt: Optional[str] = None):
        """The LNS product adds operand codes: one shared format only."""
        wfmt = self.weights.fmt if wfmt is None else wfmt
        if (pol.impl in SINGLE_FORMAT_IMPLS and pol.quantized
                and pol.fmt != wfmt):
            raise ValueError(
                f"policy {self.name!r}: op-site {op}:{site}: the LNS "
                f"product is single-format, but impl={pol.impl!r} pairs "
                f"activation fmt {pol.fmt!r} with weight fmt {wfmt!r}. "
                "Use one format for both, or impl='auto'/'fused_dequant' "
                "for mixed-format matmuls."
            )

    # ------------------------------------------------------------------ #
    def resolve(self, op: str, site: str = "") -> OpPolicy:
        """The effective :class:`OpPolicy` of ``op`` at ``site``.

        Starts from the op class's base policy; each matching override
        (same op class, glob pattern matching ``site``) replaces it, last
        match winning.
        """
        if op not in OP_CLASSES:
            raise KeyError(f"unknown op class {op!r}; one of {OP_CLASSES}")
        pol = getattr(self, op)
        for ov in self.overrides:
            if ov.matches(op, site):
                pol = ov.policy
        return pol

    def resolve_shard(self, site: str) -> Optional[str]:
        """The TP placement role pinned for a weight site, or None when
        the policy leaves placement to the serving defaults.  Glob
        patterns match like :meth:`resolve`, last match winning."""
        role = None
        for pat, r in self.shard_specs:
            if fnmatch.fnmatchcase(site, pat):
                role = r
        return role

    # Convenience views used all over the model/serving code ------------ #
    @property
    def act_quant(self) -> bool:
        return self.matmul.quantized

    @property
    def weight_quant(self) -> bool:
        return self.weights.quantized

    @property
    def ste_weights(self) -> bool:
        """Weights quantized on the fly each step (training STE path)."""
        return self.weights.quantized and not self.static_weights

    @property
    def kv_quantized(self) -> bool:
        return self.kv_write.quantized

    @property
    def kv_fmt(self) -> Optional[str]:
        return self.kv_write.fmt if self.kv_write.quantized else None

    @property
    def elementwise_quant(self) -> bool:
        return self.elementwise.quantized

    def replace(self, **kw) -> "Policy":
        return dataclasses.replace(self, **kw)

    # JSON round trip ---------------------------------------------------- #
    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"name": self.name}
        for op in OP_CLASSES:
            d[op] = getattr(self, op).to_dict()
        d["static_weights"] = self.static_weights
        d["overrides"] = [ov.to_dict() for ov in self.overrides]
        d["shard_specs"] = [list(s) for s in self.shard_specs]
        return d

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "Policy":
        kw: Dict[str, Any] = {"name": d.get("name", "custom")}
        for op in OP_CLASSES:
            if op in d:
                kw[op] = OpPolicy.from_dict(d[op])
        kw["static_weights"] = bool(d.get("static_weights", False))
        kw["overrides"] = tuple(
            Override.from_dict(o) for o in d.get("overrides", ())
        )
        kw["shard_specs"] = tuple(
            (s[0], s[1]) for s in d.get("shard_specs", ())
        )
        return cls(**kw)

    def to_json(self, **dumps_kw) -> str:
        return json.dumps(self.to_dict(), sort_keys=True, **dumps_kw)

    @classmethod
    def from_json(cls, s: str) -> "Policy":
        return cls.from_dict(json.loads(s))


# --------------------------------------------------------------------------- #
# Preset registry
# --------------------------------------------------------------------------- #
_REGISTRY: Dict[str, Policy] = {}


def register_policy(policy: Policy, *, name: Optional[str] = None) -> Policy:
    """Register ``policy`` under ``name`` (default: its own name)."""
    name = name or policy.name
    if policy.name != name:
        policy = policy.replace(name=name)
    _REGISTRY[name] = policy
    return policy


def get_policy(name_or_policy: Union[str, Policy]) -> Policy:
    """Look up a preset by name (pass-through for Policy instances)."""
    if isinstance(name_or_policy, Policy):
        return name_or_policy
    try:
        return _REGISTRY[name_or_policy]
    except KeyError:
        raise KeyError(
            f"unknown numerics policy {name_or_policy!r}; registered: "
            f"{sorted(_REGISTRY)}"
        ) from None


def available_policies() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


_W8 = OpPolicy(fmt="e4m3", mode="rne", impl="auto", accum="bf16")
_KV8 = OpPolicy(fmt="e5m2", mode="stochastic", impl="auto", accum="f32")
_ATTN8 = OpPolicy(fmt="e5m2", mode="rne", impl="auto", accum="f32")

# Everything full precision: the bf16 training/serving baseline.
register_policy(Policy(name="train_bf16"))

# W8A8 training with the STE: activations E5M2 (range), weights E4M3
# (precision), impl resolved per (shape, backend) by the autotuner.
register_policy(Policy(
    name="train_fp8",
    matmul=OpPolicy(fmt="e5m2", mode="rne", impl="auto", accum="bf16"),
    weights=_W8,
))

# Legacy `--quant fp8_lns`: same recipe pinned to the XLA dequant matmul.
register_policy(Policy(
    name="train_fp8_xla",
    matmul=OpPolicy(fmt="e5m2", mode="rne", impl="xla", accum="bf16"),
    weights=_W8,
))

# Legacy `--quant fp8_lns_pallas`: pinned to the paper-faithful Pallas LNS
# kernel.  Single-format product => both sides E4M3.
register_policy(Policy(
    name="train_fp8_lns",
    matmul=OpPolicy(fmt="e4m3", mode="rne", impl="lns", accum="bf16"),
    weights=_W8,
))

# Weight-only STE training (legacy `--quant fp8_w8_train`).
register_policy(Policy(name="train_fp8_weight_only", weights=_W8))

# Static weight-only FP8 inference (legacy `--quant fp8_w8`).
register_policy(Policy(
    name="weight_only_e4m3", weights=_W8, static_weights=True,
))

# The serving preset (legacy `--quant fp8_w8kv8`): static E4M3 weights,
# E5M2 paged KV cache with stochastic-rounding writes/rescales, paged
# decode attention computing QK^T in the LNS integer domain.
register_policy(Policy(
    name="serve_fp8_paged",
    weights=_W8,
    static_weights=True,
    attention_qk=_ATTN8,
    attention_pv=_ATTN8,
    kv_write=_KV8,
    kv_rescale=_KV8,
))

# Mixed-precision demonstration preset: E5M2 activations everywhere except
# the attention projections, which drop to E4M3 via per-site overrides
# (narrow dynamic range after the qk-norm; precision matters more there).
register_policy(Policy(
    name="train_fp8_attn_e4m3",
    matmul=OpPolicy(fmt="e5m2", mode="rne", impl="auto", accum="bf16"),
    weights=_W8,
    overrides=(
        Override("matmul", "blocks.*.attn.w[qkvo]",
                 OpPolicy(fmt="e4m3", mode="rne", impl="auto", accum="bf16")),
        Override("matmul", "prefix.*.attn.w[qkvo]",
                 OpPolicy(fmt="e4m3", mode="rne", impl="auto", accum="bf16")),
    ),
))
