"""Logical-axis sharding rules for parameters and activations (port of
``repro.distributed.sharding``, on a ``torch.distributed`` DeviceMesh).

Models never name mesh axes directly: they request *logical* axes
("act_batch", "heads", "ff", ...) through :func:`constrain`, and parameter
placements come from the path rules of :func:`param_specs`.  The mapping
logical -> mesh is installed per run (train / serve) with
:func:`logical_rules`; outside any rules context, and for a tensor that is
not a DTensor, every constraint returns its input as it is, so the meshless
path runs the same model code unchanged.

Mesh axes: ("pod",) "data", "model".  Policy per arch (``cfg.attn_shard``):
* tp_heads  - attention heads over 'model' (Megatron TP);
* context   - heads not divisible by the model axis: softmax attention is
  sequence-sharded over 'model', LLN attention is replicated over 'model';
* replicate - the model axis unused by attention (tiny models).

A spec is the reference's ``PartitionSpec``: per tensor dim, None, a mesh
axis name or a tuple of them.  Every spec is divisibility-checked against
the dim size and the mesh (:func:`fit_spec`): axes that do not divide are
dropped.  :func:`to_placements` turns a spec into DTensor placements
(``Shard(d)`` / ``Replicate()`` per mesh dim).

A port leaf's path is the reference's path for it: ``layers.3.attn.q_w``
reads as ``layers/attn/q_w`` and ``embed_table`` as ``embed/table`` (the
name map of ``convert.py``).  The reference stacks its layers and puts a
leading None on the layer axis; the port's per-layer tensor has no layer
axis, so its spec is the reference's without that None.
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Any

import torch

_ACTIVE: dict | None = None
_MESH = None


class P(tuple):
    """A partition spec: one entry per tensor dim, each None, a mesh axis
    name or a tuple of names (``P("data", None)``, as the reference's
    ``PartitionSpec``)."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``NamedSharding``); ``placements``
    are its DTensor placements."""
    mesh: Any
    spec: P

    @property
    def placements(self) -> tuple:
        return to_placements(self.spec, self.mesh)


def mesh_axes(mesh) -> dict:
    """``{axis name: size}`` of a DeviceMesh, or of any object with the
    reference mesh's ``axis_names`` and ``devices.shape``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(zip(mesh.axis_names, tuple(mesh.devices.shape)))


@contextlib.contextmanager
def logical_rules(mesh, rules: dict[str, tuple]):
    """Install a logical->mesh axis mapping (and the mesh) for model code."""
    global _ACTIVE, _MESH
    prev, prev_mesh = _ACTIVE, _MESH
    _ACTIVE, _MESH = rules, mesh
    try:
        yield
    finally:
        _ACTIVE, _MESH = prev, prev_mesh


def current_mesh():
    return _MESH


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = mesh_axes(mesh)
    size = 1
    for a in axes:
        size *= sizes.get(a, 1)   # absent axes (e.g. 'pod' on 1-pod) drop
    return size


def fit_spec(spec: P, shape, mesh) -> P:
    """Drop spec axes whose mesh size does not divide the dim size, and
    de-duplicate mesh axes across dims (first occurrence wins)."""
    names = tuple(mesh_axes(mesh))
    out = []
    used: set = set()
    for dim, axes in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if axes is None:
            out.append(None)
            continue
        cand = axes if isinstance(axes, tuple) else (axes,)
        kept = []
        for a in cand:
            if a in used or a not in names:
                continue
            sz = _axis_size(mesh, tuple(kept) + (a,))
            if dim % sz == 0:
                kept.append(a)
                used.add(a)
        out.append(tuple(kept) if len(kept) > 1 else
                   (kept[0] if kept else None))
    return P(*out)


def to_placements(spec: P, mesh) -> tuple:
    """DTensor placements of a (fitted) spec: ``Shard(d)`` on each mesh dim
    that shards tensor dim d, ``Replicate()`` on the others.  A dim sharded
    over several mesh axes (``("pod", "data")``) takes them in mesh order,
    outer first."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh_axes(mesh))
    owner = {}
    for d, axes in enumerate(spec):
        if axes is None:
            continue
        axes = axes if isinstance(axes, tuple) else (axes,)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"spec {spec!r}: axes {axes} of dim {d} are "
                             f"not in the mesh's order {tuple(names)}")
        for a in axes:
            owner[a] = d
    return tuple(Shard(owner[a]) if a in owner else Replicate()
                 for a in names)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def replicated_like(x, t: torch.Tensor):
    """``t``, a tensor every rank holds whole, as a replicated DTensor on
    ``x``'s mesh when ``x`` is a DTensor (DTensor ops take no plain
    tensor operands); ``t`` itself otherwise."""
    if not is_dtensor(x):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    mesh = x.device_mesh
    return DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim,
                              run_check=False)


def redistributed(t, placements):
    """``t.redistribute`` onto ``placements`` on its own mesh.  A
    parameter (which requires grad) under ``torch.inference_mode`` is
    redistributed outside it, without a graph: there the redistribute's
    autograd Function needs ``aten.detach_``, which some torch versions
    have no DTensor strategy for."""
    placements = tuple(placements)
    if tuple(t.placements) == placements:
        return t
    if t.requires_grad and torch.is_inference_mode_enabled():
        with torch.inference_mode(False), torch.no_grad():
            return t.redistribute(t.device_mesh, placements)
    return t.redistribute(t.device_mesh, placements)


def matmul(x, w):
    """``x @ w`` for a (..., d_in) activation and a (d_in, d_out) weight.
    On a mesh, DTensor refuses to flatten the leading dims of a product's
    input or gradient when an inner dim is split (the sequence under
    ``act_seq``): that dim of ``x`` is gathered first, as GSPMD does for a
    sequence-parallel residual, and the gradients of the product and of
    its input are placed as they are before they reach the ops that made
    them."""
    if not is_dtensor(x):
        return x @ w
    from torch.distributed.tensor import Replicate
    pl = tuple(Replicate() if p.is_shard() and 0 < p.dim < x.ndim - 1
               else p for p in x.placements)
    x = redistributed(x, pl)
    # x's gradient is placed as x before it reaches the ops that made x:
    # the product's backward leaves it split on its last dim where the
    # weight's input dim is split, which a view such as the heads' flatten
    # cannot take back when the heads do not divide the mesh dim.
    x = _relocal(x)
    return _relocal(x @ w)


def _relocal(t):
    """``t`` as a new DTensor over its own local shard (the global shape
    given: a shard may be uneven), whose gradient arrives placed as ``t``
    is."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(t.to_local(), t.device_mesh, t.placements,
                              run_check=False, shape=t.shape,
                              stride=t.stride())


def split_heads(t, heads: int, head_dim: int):
    """A projection's (..., heads * head_dim) output as (..., heads,
    head_dim).  On a mesh a last dim split over a mesh dim that the heads
    do not divide (yi-9b's 4 kv heads over 'model' = 16) is gathered
    first, as GSPMD does: DTensor cannot split such a shard in two."""
    if is_dtensor(t):
        from torch.distributed.tensor import Replicate
        mesh = t.device_mesh
        last = t.ndim - 1
        t = redistributed(t, tuple(
            Replicate() if p.is_shard(last) and heads % mesh.shape[i]
            else p for i, p in enumerate(t.placements)))
    return t.reshape(t.shape[:-1] + (heads, head_dim))


def pad_seq(t, total: int):
    """``t`` (B, N, ...) zero-padded on dim 1 to ``total`` positions.  On a
    mesh the pad runs on each rank's shard, dim 1 whole there (torch 2.11's
    DTensor has no strategy for a pad on a 2-D mesh)."""
    import torch.nn.functional as F
    pad = (0, 0) * (t.ndim - 2) + (0, total - t.shape[1])
    if not is_dtensor(t):
        return F.pad(t, pad)
    from torch.distributed.tensor import DTensor, Replicate
    t = redistributed(t, tuple(Replicate() if p.is_shard(1) else p
                               for p in t.placements))
    out = F.pad(t.to_local(), pad)
    shape = (t.shape[0], total) + tuple(t.shape[2:])
    return DTensor.from_local(out, t.device_mesh, t.placements,
                              run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta")
                              .stride())


def spec_placements(x_shape, logical_axes, mesh=None, rules=None) -> tuple:
    """Placements of the logical axes under the active (or given) rules,
    fitted to ``x_shape``."""
    mesh = _MESH if mesh is None else mesh
    rules = _ACTIVE if rules is None else rules
    axes = tuple(rules.get(a) if isinstance(a, str) else a
                 for a in logical_axes)
    return to_placements(fit_spec(P(*axes), x_shape, mesh), mesh)


def constrain(x, *logical_axes):
    """Place an activation by logical axis names: ``x.redistribute`` onto
    the fitted spec when rules are active and ``x`` is a DTensor; ``x`` as
    it is otherwise."""
    if _ACTIVE is None or _MESH is None or not is_dtensor(x):
        return x
    placements = spec_placements(x.shape, logical_axes)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)


# ---------------------------------------------------------------------------
# Parameter sharding from path rules.
# ---------------------------------------------------------------------------

# (regex on 'a/b/c' path, spec builder).  First match wins.  Specs are
# written for the *unstacked* trailing dims; stacked layer params get a
# leading None automatically (detected by the 'layers' path component).
# FSDP axis is ('pod', 'data'): on the single-pod mesh 'pod' is absent and
# drops out; on the multi-pod mesh params/optimizer shard over both.
_FSDP = ("pod", "data")
_PARAM_RULES: list[tuple[str, tuple]] = [
    (r"embed/table$",        ("model", _FSDP)),        # (V, D)
    (r"lm_head$",            (_FSDP, "model")),        # (D, V)
    (r"(router|gate)_w$",    (_FSDP, None)),           # (D, E)
    (r"exp_(wi|wi_gate|wi_up)$", ("model", _FSDP, None)),     # (E, D, F)
    (r"exp_wo$",             ("model", None, _FSDP)),         # (E, F, D)
    (r"(o_w|wo|wo_shared|out_w)$", ("model", _FSDP)),         # (F|HD, D)
    (r"(conv_w)$",           (None, None)),
    (r"(a_log|d_skip|dt_bias)$", (None,)),
    (r"\w*(scale|bias)$",    (None,)),
    (r".*",                  (_FSDP, "model")),        # generic 2D (D, F)
]

# Port parameter trees whose entries the reference stacks on a leading
# layer axis.
_STACKS = ("first_layers", "layers", "enc_layers")


def _spec_for_path(path: str, shape: tuple[int, ...]) -> P:
    stacked = path.startswith("layers/") or "/layers/" in path
    ndim = len(shape)
    for pat, axes in _PARAM_RULES:
        if re.search(pat, path):
            base = list(axes)
            break
    # Adjust rank: pad/truncate the trailing spec to the unstacked rank.
    core_rank = ndim - 1 if stacked else ndim
    if len(base) < core_rank:
        base = [None] * (core_rank - len(base)) + base
    base = base[-core_rank:] if core_rank else []
    if stacked:
        base = [None] + base
    return P(*base)


def reference_path(path: tuple) -> str:
    """The reference's key path of a port leaf: the per-layer index after
    a stack name goes (``layers.3.attn.q_w`` -> ``layers/attn/q_w``) and
    ``embed_table`` reads ``embed/table``."""
    parts: list[str] = []
    for key in path:
        parts.extend(str(key).split("."))
    out = []
    for i, part in enumerate(parts):
        if part.isdigit() and i and parts[i - 1] in _STACKS:
            continue
        out.extend(["embed", "table"] if part == "embed_table" else [part])
    return "/".join(out)


def _is_stacked(path: tuple) -> bool:
    parts = [q for k in path for q in str(k).split(".")]
    return any(a in _STACKS and b.isdigit() for a, b in zip(parts, parts[1:]))


def param_specs(params, mesh):
    """``{path string: P}`` for every tensor leaf of a parameter tree (an
    ``nn.Module``, the train state, or any tree of ``repro_torch.tree``),
    divisibility-fitted.  A per-layer leaf takes the spec of the
    reference's stacked one without its layer axis."""
    from repro_torch import tree as tr

    def leaf_spec(path, shape):
        rpath = reference_path(path)
        if _is_stacked(path):
            spec = _spec_for_path(rpath, (1,) + shape)
            return fit_spec(P(*tuple(spec)[1:]), shape, mesh)
        return fit_spec(_spec_for_path(rpath, shape), shape, mesh)
    return {tr.path_str(p): leaf_spec(p, tuple(leaf.shape))
            for p, leaf in tr.leaves_with_path(params)}


def param_shardings(params, mesh):
    """``{path string: NamedSharding}`` of a parameter tree on ``mesh``."""
    return {k: NamedSharding(mesh, s)
            for k, s in param_specs(params, mesh).items()}


def place_leaf(t: torch.Tensor, sharding: NamedSharding):
    """One leaf on ``sharding``: a DTensor is redistributed on its own
    mesh, or gathered whole and re-split onto another; a plain tensor,
    the whole array on every rank, keeps each rank's slice without
    communication."""
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.distributed.tensor import DTensor, distribute_tensor
    want = sharding.placements
    if is_dtensor(t):
        if t.device_mesh == sharding.mesh:
            return t if tuple(t.placements) == want else t.redistribute(
                sharding.mesh, want)
        t = t.full_tensor()
    if isinstance(t, FakeTensor):
        # An abstract tensor (``launch/dryrun.py``): distribute_tensor's
        # offset arithmetic reads tensor values, which a fake has none of.
        return DTensor.from_local(
            local_slice(t.detach(), sharding.mesh, want).contiguous(),
            sharding.mesh, want, run_check=False)
    return distribute_tensor(t.detach(), sharding.mesh, want,
                             src_data_rank=None)


def local_slice(t: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's shard of the whole tensor ``t`` under ``placements``
    (``torch.chunk``'s split, mesh dims outer first), a view."""
    coord = mesh.get_coordinate()
    for i, p in enumerate(placements):
        if p.is_shard():
            size = t.shape[p.dim]
            chunk = -(-size // mesh.shape[i])
            start = min(coord[i] * chunk, size)
            t = t.narrow(p.dim, start, min(chunk, size - start))
    return t


def local_rows(t) -> torch.Tensor:
    """The global indices of the rows (dim 0) of DTensor ``t`` that this
    rank holds (``torch.chunk``'s split, as :func:`local_slice`)."""
    from torch.distributed.tensor import Replicate
    rows = [p if p.is_shard(0) else Replicate() for p in t.placements]
    return local_slice(torch.arange(t.shape[0], device=t.to_local().device),
                       t.device_mesh, rows)


def map_rows(t, fn):
    """``fn(local tensor, global row indices) -> new local tensor`` on each
    rank's shard of ``t`` (rows on dim 0), rebuilt in ``t``'s placements
    with no communication; a plain tensor is ``fn(t, arange(B))``.  The
    serving pool's row writes (admit, evict, a poisoned row) use it on
    DTensor caches: each rank writes the rows it holds."""
    if not is_dtensor(t):
        return fn(t, torch.arange(t.shape[0], device=t.device))
    from torch.distributed.tensor import DTensor
    out = t.to_local()
    if t.device_mesh.get_coordinate() is not None:
        out = fn(out, local_rows(t))
    return DTensor.from_local(out, t.device_mesh, t.placements,
                              run_check=False, shape=t.shape,
                              stride=t.stride())


def any_over_mesh(flags: torch.Tensor, mesh) -> torch.Tensor:
    """``flags`` (bool, whole on every rank, each rank's own findings) OR-ed
    over every rank of ``mesh``: each rank ends with the same vector."""
    import torch.distributed as dist
    if mesh.get_coordinate() is None:
        return flags
    out = flags.to(torch.int32)
    for i in range(mesh.ndim):
        if mesh.shape[i] > 1:
            dist.all_reduce(out, op=dist.ReduceOp.MAX,
                            group=mesh.get_group(i))
    return out.bool()


def set_parameter(module: torch.nn.Module, name: str, t: torch.Tensor):
    """Replace parameter ``name`` of ``module`` by ``t``."""
    owner, _, attr = name.rpartition(".")
    mod = module.get_submodule(owner) if owner else module
    old = mod._parameters[attr]
    mod._parameters[attr] = torch.nn.Parameter(
        t, requires_grad=old.requires_grad)


def shard_tree(tree, shardings):
    """Place every tensor leaf of ``tree`` by ``shardings`` (``{path
    string: NamedSharding}``, as :func:`param_shardings` gives;
    :func:`place_leaf`).  Parameters of an ``nn.Module`` are replaced in
    place; other trees are returned rebuilt."""
    from repro_torch import tree as tr
    if isinstance(tree, torch.nn.Module):
        with torch.no_grad():
            for name, p in list(tree.named_parameters()):
                set_parameter(tree, name, place_leaf(p, shardings[name]))
        return tree
    if isinstance(tree, dict) and any(isinstance(v, torch.nn.Module)
                                      for v in tree.values()):
        return {k: shard_tree(v, {p[len(k) + 1:]: s
                                  for p, s in shardings.items()
                                  if p.startswith(f"{k}/")})
                for k, v in tree.items()}
    return tr.map_with_path(
        lambda p, a: place_leaf(a, shardings[tr.path_str(p)]), tree)


# ---------------------------------------------------------------------------
# Per-arch logical rule tables.
# ---------------------------------------------------------------------------

def make_rules(cfg, *, multi_pod: bool, serve: bool = False) -> dict:
    """Logical->mesh mapping for one arch config (see module docstring).

    Key activations axes:
    * act_seq  - the residual stream's sequence axis *between* blocks.
      'model' = Megatron-style sequence parallelism (the remat stash and
      norms are 1/model_size per device; attention/MLP gather as needed).
      Disabled for SSM families whose chunk scan would slice a sharded dim.
    * attn_seq - the sequence axis *inside* attention: 'model' only for
      context-parallel softmax archs; None otherwise (TP archs shard heads,
      and LLN attention is cheap enough to replicate for CP archs).
    * act_seq_cache - decode KV-cache sequence axis: 'model' when kv heads
      cannot use the model axis (flash-decode style cache sharding).
    """
    batch_axes = ("pod", "data") if multi_pod else ("data",)
    rules: dict[str, object] = {
        "act_batch": batch_axes,
        "act_seq": "model",
        "attn_seq": None,
        "act_seq_cache": None,
        "embed": None,
        "ff": "model",
        "vocab": "model",
        "kv_heads": "model",
        "heads": "model",
        "head_dim": None,
        "experts": "model",
        "state_d": None,
    }
    if cfg.attn_shard == "context":
        rules["heads"] = None
        rules["kv_heads"] = None
        rules["act_seq_cache"] = "model"
        if cfg.attn_impl == "softmax":
            rules["attn_seq"] = "model"
    elif cfg.attn_shard == "replicate":
        rules["heads"] = None
        rules["kv_heads"] = None
        # Tiny models: fold the model axis into batch when it divides.
        rules["act_batch"] = batch_axes + ("model",)
        rules["act_seq"] = None
    if cfg.family in ("ssm", "hybrid"):
        rules["act_seq"] = None     # SSD chunk scan must not slice a
        rules["attn_seq"] = None    # 'model'-sharded sequence dim
    return rules
