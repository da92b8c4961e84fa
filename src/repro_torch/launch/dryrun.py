"""Production-mesh dry run (port of ``repro.launch.dryrun``): trace one step
per (arch x shape x mesh) on the 256-rank (16 x 16) or 512-rank
(2 x 16 x 16) mesh with nothing launched, and record its per-rank sizes,
flops and collective schedule.

The reference lowers and compiles the step on 256 or 512 fake host
devices.  Here the process starts a ``fake`` process group of that many
ranks itself (a ``FakeStore``; this process is rank 0 and its collectives
return at once), builds the production mesh on it and runs the step under
``FakeTensorMode``: the state, batch and caches are each rank's local
shard as DTensors of fake tensors, so every op runs on shapes only.  The
fake tensors' device type is ``cuda`` where torch is built with CUDA (the
card's program, no card needed) and ``cpu`` on a CPU-only build, whose
autograd refuses a cuda tensor.  Like the reference, a cell must run in a
process of its own (the group binds at start); ``--all`` spawns one
subprocess per cell.

The traced path is the core path by default, as the reference's
(``use_kernel`` defaults to False there): serving takes the plain PyTorch
versions of the kernels (``attn_backend="plain"``).  ``--override
use_kernel=True`` traces the hand kernels instead: each kernel's CUDA
branch is a ``torch.library`` custom op (``repro_torch::<wrapper>``) whose
fake implementation gives its outputs' shapes, so such a cell runs on fake
``cuda`` tensors (the wrappers take their CUDA branch) and launches
nothing.  That needs a torch built with CUDA: on a CPU-only build the
Python bindings of ``Tensor.__getitem__``, ``Tensor.contiguous`` and
``Tensor.copy_``, and the fake of DTensor's ``_dtensor::shard_dim_alltoall``,
open a CUDA device guard that the build has not, so there the cell is
refused before any group starts.  As in the reference, whose Pallas calls
pass no ``cost_estimate``, ``flops`` leaves out the kernels' products: only
``torch``'s own products are counted.

Output keys, as the reference's where they mean something here: ``arch``,
``shape``, ``mesh``, ``kind``, ``attn_impl``, ``overrides``, ``devices``,
``ok``; ``lower_s`` the trace time; ``flops`` the matrix-product and
convolution flops of one rank's local ops (``torch.utils.flop_counter``'s
formulas; XLA's count covered every op); ``argument_size_in_bytes`` /
``output_size_in_bytes`` one rank's local bytes of the step's tensor
inputs and outputs (training: the state and the batch; serving: the
parameters, the batch or the caches and the token; a decode position is a
Python int); ``temp_size_in_bytes`` the peak of the bytes the step
allocates on one rank above its arguments (outputs included);
``collectives`` ``{op: {count, bytes}}`` under the reference's names, the
bytes each rank's outputs; ``kernel_ops`` ``{op: calls}`` of one rank's
hand-kernel custom ops (empty on the core path).  ``compile_s``, ``bytes_accessed``,
``generated_code_size_in_bytes`` and ``alias_size_in_bytes`` have no
meaning without a compiler and are left out.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b \\
      --shape train_4k --override n_layers=2
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b \\
      --shape decode_32k --multi-pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback
import weakref

import torch

# c10d op name -> the reference's collective name.
_COLLECTIVES = {"all_gather_into_tensor": "all-gather",
                "all_gather": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "all_reduce": "all-reduce", "allreduce_": "all-reduce",
                "all_to_all_single": "all-to-all",
                "alltoall_base_": "all-to-all"}
_PRODUCTS = ("mm", "addmm", "bmm", "baddbmm", "convolution",
             "_convolution")
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def parse_overrides(s: str) -> dict:
    """'n_layers=2,scan_unroll=1,remat=none' -> typed override dict."""
    out = {}
    if not s:
        return out
    for item in s.split(","):
        k, v = item.split("=")
        if v in ("True", "False"):
            out[k] = v == "True"
        else:
            try:
                out[k] = int(v)
            except ValueError:
                try:
                    out[k] = float(v)
                except ValueError:
                    out[k] = v
    return out


def _local(t) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    return t._local_tensor if isinstance(t, DTensor) else t


def local_bytes(tree) -> int:
    """One rank's bytes of the tensors in ``tree`` (DTensors by their local
    shard)."""
    from repro_torch.tree import leaves_with_path
    total = 0
    for _, t in leaves_with_path(tree):
        t = _local(t)
        total += t.numel() * t.element_size()
    return total


def _in_sharding_propagation(depth: int = 16) -> bool:
    """Whether the op being dispatched is DTensor's sharding propagation
    running it on global-shape fake tensors to learn its output's metadata
    (``ShardingPropagator._propagate_tensor_meta_non_cached``), which no
    rank computes."""
    frame = sys._getframe(2)
    for _ in range(depth):
        if frame is None:
            return False
        if frame.f_code.co_name == "_propagate_tensor_meta_non_cached":
            return True
        frame = frame.f_back
    return False


class StepTrace(torch.utils._python_dispatch.TorchDispatchMode):
    """One rank's view of a traced step (DTensor's sharding propagation,
    which runs ops on global shapes to learn their metadata, left out: its
    cache makes it a cost of the first trace only): the local ops'
    matrix-product flops, the collectives (count and output bytes), the hand kernels'
    custom ops (calls per op) and the peak of the bytes allocated while it
    is on.  A DTensor op is handed on to
    DTensor's own dispatch (``NotImplemented``), so the local ops it
    issues are the ones counted."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.collectives: dict = {}
        self.kernel_ops: dict = {}
        self.live = self.peak = 0
        self._seen: set = set()

    def _alloc(self, t):
        try:
            storage = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return
        key = storage._cdata
        if key in self._seen:
            return
        n = storage.nbytes()
        self._seen.add(key)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(t, self._free, key, n)

    def _free(self, key, n):
        self._seen.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils._pytree import tree_leaves
        from torch.utils.flop_counter import flop_registry
        kwargs = kwargs or {}
        flat = tree_leaves((args, kwargs))
        if any(isinstance(a, DTensor) for a in flat):
            return NotImplemented      # DTensor's dispatch: its local ops
                                       # come back here
        if _in_sharding_propagation():
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        name = func._overloadpacket.__name__
        if name in _COLLECTIVES:
            res = [t for t in tree_leaves(out) if torch.is_tensor(t)]
            if name.endswith("_"):            # in place: its tensor argument
                res = [t for t in flat if torch.is_tensor(t)][:1]
            rec = self.collectives.setdefault(_COLLECTIVES[name],
                                              {"count": 0, "bytes": 0})
            rec["count"] += 1
            rec["bytes"] += sum(t.numel() * t.element_size() for t in res)
        elif func.namespace == "repro_torch":
            self.kernel_ops[name] = self.kernel_ops.get(name, 0) + 1
        elif name in _PRODUCTS and func._overloadpacket in flop_registry:
            self.flops += flop_registry[func._overloadpacket](
                *args, **kwargs, out_val=out)
        for t in tree_leaves(out):
            if torch.is_tensor(t):
                self._alloc(t)
        return out


def start_fake_group(world: int) -> None:
    """This process as rank 0 of a ``fake`` group of ``world`` ranks."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(f"a group of {dist.get_world_size()} ranks "
                               f"is up; the cell needs {world}")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def fake_device() -> str:
    return "cuda" if torch.backends.cuda.is_built() else "cpu"


def cell_config(arch: str, shape_name: str, attn_impl: str = "auto",
                overrides: dict | None = None):
    """(config, impl, shape) of one cell: the reference's ``auto`` impl
    rule (``long_500k`` needs sub-quadratic attention: the attention archs
    run it in ``lln_diag``, the SSM archs natively) and the overrides.
    Serving takes the kernels' plain versions, or, under ``use_kernel``
    (or ``attn_backend=kernel``), the kernels' custom ops."""
    from repro_torch.configs import SHAPES_BY_NAME, get_config
    shape = SHAPES_BY_NAME[shape_name]
    cfg = get_config(arch)
    impl = attn_impl
    if impl == "auto":
        if shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
            impl = "lln_diag"
        else:
            impl = cfg.attn_impl
    cfg = cfg.replace(attn_impl=impl, **(overrides or {}))
    if uses_kernels(cfg):
        return cfg.replace(use_kernel=True, attn_backend="kernel"), impl, \
            shape
    return cfg.replace(attn_backend="plain"), impl, shape


def uses_kernels(cfg) -> bool:
    """Whether a cell traces the hand kernels (on fake ``cuda``)."""
    return bool(cfg.use_kernel) or cfg.attn_backend == "kernel"


def check_kernel_trace() -> None:
    """Refuse a kernel cell on a torch built without CUDA (see the module
    docstring): the ops named there cannot run on its fake ``cuda``
    tensors."""
    if not torch.backends.cuda.is_built():
        raise RuntimeError(
            "use_kernel=True traces on fake cuda tensors, which this "
            "CPU-only torch build cannot: Tensor.__getitem__, "
            "Tensor.contiguous, Tensor.copy_ and the fake of "
            "_dtensor::shard_dim_alltoall open a CUDA device guard; run the "
            "cell where torch is built with CUDA")


def _whole_batch(cfg, shape, device) -> dict:
    """The step's batch, whole (fake): tokens, targets, the loss mask and
    the family's frames or patches (``steps.batch_struct``'s shapes)."""
    b, n = shape.global_batch, shape.seq_len
    n_text = max(n - cfg.num_prefix_tokens, 8) if cfg.family == "vlm" else n
    out = {k: torch.zeros(b, n_text, dtype=torch.int64, device=device)
           for k in ("inputs", "targets")}
    out["mask"] = torch.ones(b, n_text, device=device)
    if cfg.family == "encdec":
        out["src"] = torch.zeros(b, n, cfg.frontend_dim, device=device)
    if cfg.family == "vlm":
        out["patches"] = torch.zeros(b, cfg.num_prefix_tokens,
                                     cfg.frontend_dim, device=device)
    return out


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             attn_impl: str = "auto", overrides: dict | None = None) -> dict:
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_production_mesh
    cfg, impl, shape = cell_config(arch, shape_name, attn_impl, overrides)
    kernels = uses_kernels(cfg)
    if kernels:
        check_kernel_trace()
    world = 512 if multi_pod else 256
    start_fake_group(world)
    device = "cuda" if kernels else fake_device()
    mesh = make_production_mesh(multi_pod=multi_pod, device=device)
    result = {"arch": arch, "shape": shape_name,
              "mesh": "2x16x16" if multi_pod else "16x16",
              "kind": shape.kind, "attn_impl": impl,
              "overrides": overrides or {}, "devices": world}
    trace = StepTrace()
    with FakeTensorMode():
        t0 = time.time()
        if shape.kind == "train":
            setup = steps.make_train_setup(cfg, shape, mesh=mesh)
            state = setup.init_state(None)
            batch = steps.place_batch(_whole_batch(cfg, shape, device),
                                      steps.batch_struct(cfg, shape, mesh,
                                                         setup.rules), mesh)
            args = (state, batch)
            with trace:
                out = setup.step_fn(state, batch)
        else:
            setup = steps.make_serve_setup(cfg, shape, mesh=mesh)
            params = setup.shard_params(setup.model.init(None))
            b = shape.global_batch
            if shape.kind == "prefill":
                batch = _whole_batch(cfg, shape, device)
                batch = steps.place_batch(
                    {k: v for k, v in batch.items()
                     if k in ("inputs", "src", "patches")},
                    steps.batch_struct(cfg, shape, mesh, setup.rules), mesh)
                args = (params, batch)
                with trace:
                    out = setup.prefill_fn(params, batch)
            else:
                # Inference tensors, as a prefill leaves them.
                with torch.inference_mode():
                    caches = setup.model.cache_init(None, b, shape.seq_len)
                    caches = shd.shard_tree(caches,
                                            setup.cache_shardings(caches))
                    token = shd.place_leaf(
                        torch.zeros(b, dtype=torch.int64, device=device),
                        shd.NamedSharding(mesh, shd.fit_spec(
                            shd.P(setup.rules["act_batch"]), (b,), mesh)))
                args = (params, caches, token)
                with trace:
                    out = setup.decode_fn(params, caches, token,
                                          shape.seq_len - 1)
        result["lower_s"] = round(time.time() - t0, 2)
    result["flops"] = float(trace.flops)
    result["argument_size_in_bytes"] = local_bytes(args)
    result["output_size_in_bytes"] = local_bytes(out)
    result["temp_size_in_bytes"] = int(trace.peak)
    result["collectives"] = trace.collectives
    result["kernel_ops"] = trace.kernel_ops
    result["ok"] = True
    return result


def _out_path(out_dir, arch, shape, mesh_tag):
    os.makedirs(out_dir, exist_ok=True)
    return os.path.join(out_dir, f"{arch}__{shape}__{mesh_tag}.json")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--attn-impl", default="auto",
                    choices=["auto", "softmax", "lln", "lln_diag"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--override", default="",
                    help="cfg overrides, e.g. n_layers=2,remat=none")
    ap.add_argument("--tag", default="",
                    help="suffix for the output filename (probe runs)")
    args = ap.parse_args(argv)

    if args.all:
        from repro_torch.configs.registry import ASSIGNED_ARCHS
        meshes = [False, True] if args.both_meshes else [False]
        failures = []
        for arch in ASSIGNED_ARCHS:
            for shape in SHAPES:
                for mp in meshes:
                    tag = "2x16x16" if mp else "16x16"
                    path = _out_path(args.out, arch, shape, tag)
                    if args.skip_existing and os.path.exists(path):
                        print(f"[skip] {path}")
                        continue
                    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                           "--arch", arch, "--shape", shape, "--out",
                           args.out, "--attn-impl", args.attn_impl]
                    if args.override:
                        cmd += ["--override", args.override]
                    if args.tag:
                        cmd += ["--tag", args.tag]
                    if mp:
                        cmd.append("--multi-pod")
                    print(f"[run ] {arch} {shape} {tag}", flush=True)
                    rc = subprocess.call(cmd)
                    if rc != 0:
                        failures.append((arch, shape, tag))
        print(f"DONE; {len(failures)} failures: {failures}")
        return 1 if failures else 0

    tag = "2x16x16" if args.multi_pod else "16x16"
    if args.tag:
        tag = tag + "__" + args.tag
    path = _out_path(args.out, args.arch, args.shape, tag)
    if args.skip_existing and os.path.exists(path):
        print(f"[skip] {path}")
        return 0
    try:
        result = run_cell(args.arch, args.shape, args.multi_pod,
                          args.attn_impl, parse_overrides(args.override))
    except Exception as e:
        result = {"arch": args.arch, "shape": args.shape, "mesh": tag,
                  "ok": False, "error": f"{type(e).__name__}: {e}",
                  "traceback": traceback.format_exc()[-4000:]}
    with open(path, "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps({k: v for k, v in result.items()
                      if k not in ("traceback",)}, indent=2))
    return 0 if result.get("ok") else 1


if __name__ == "__main__":
    code = main()
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    sys.exit(code)
