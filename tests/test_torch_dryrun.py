"""``launch/dryrun.py`` (item 12b): the production meshes traced with nothing
launched.

* ``parse_overrides`` equals the reference's on a set of strings (the
  reference module sets XLA flags in ``os.environ`` when imported: the
  import runs under a saved environment).
* Child processes for the production meshes (16 x 16 and 2 x 16 x 16: a
  fake group of 256 or 512 ranks lives only there) run one cell per family at
  a small ``n_layers``: each cell is ``ok``, and its per-rank
  ``argument_size_in_bytes`` equals the sum of the local shard bytes that
  the *reference's* ``param_specs`` and ``cache_shardings`` (and
  ``batch_struct``'s specs) give the port's leaves on a duck mesh of that
  shape: the port's sharding at 256 and 512 ranks held to the reference's
  rules.
* ``use_kernel=True`` traces the kernels' custom ops on fake ``cuda``
  tensors: the meshless yi-9b SMOKE kernel route here, and the production
  cell where torch is built with CUDA (a CPU-only build refuses it before
  any group starts, and the CLI writes the reference's file name with
  ``ok: false``).
"""
from __future__ import annotations

import importlib
import json
import math
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace
from unittest import mock

import jax
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import _torch_threads  # noqa: F401  (one torch thread per test worker)

import repro.launch.steps as j_steps
from repro.configs import get_config as j_get_config
from repro.distributed import sharding as j_shd
from repro.models import build_model as j_build_model
from repro.optim import adamw_init as j_adamw_init
from repro_torch.configs import SHAPES_BY_NAME
from repro_torch.launch import dryrun
from repro_torch.models import build_model
from repro_torch.tree import leaves_with_path, path_str

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
# One cell per family (arch, shape, overrides): decode cells take the
# parameters, the caches and the token; the encoder has no serving step.
CELLS = (("yi-9b", "decode_32k", {"n_layers": 1}),
         ("qwen3-moe-235b-a22b", "decode_32k", {"n_layers": 1}),
         ("deepseek-v2-236b", "decode_32k", {"n_layers": 2}),
         ("mamba2-130m", "decode_32k", {"n_layers": 1}),
         ("zamba2-7b", "decode_32k", {"n_layers": 6}),
         ("seamless-m4t-medium", "decode_32k",
          {"n_layers": 1, "enc_layers": 1}),
         ("paligemma-3b", "decode_32k", {"n_layers": 1}),
         ("roberta-lln", "train_4k", {"n_layers": 1}))
OVERRIDE_STRINGS = ("", "n_layers=2", "n_layers=2,remat=none",
                    "use_kernel=True,lln_chunk=64", "capacity_factor=1.25",
                    "attn_backend=plain,scan_unroll=False,x=1e-3")
CHILD = """
import json, sys
import torch.distributed as dist
from repro_torch.launch import dryrun
cells, multi_pod = json.loads(sys.argv[1]), sys.argv[2] == "1"
out = [dryrun.run_cell(a, s, multi_pod, "auto", o) for a, s, o in cells]
dist.destroy_process_group()
print(json.dumps(out))
"""


def _reference_dryrun():
    with mock.patch.dict(os.environ):
        import repro.launch.dryrun as j_dryrun
    return j_dryrun


def test_parse_overrides_matches_the_reference():
    j_dryrun = _reference_dryrun()
    for s in OVERRIDE_STRINGS:
        assert dryrun.parse_overrides(s) == j_dryrun.parse_overrides(s), s


def _getitem(x, idx):
    """``x[idx]`` by aten ops (basic indexing and tensor indices)."""
    idx = idx if isinstance(idx, tuple) else (idx,)
    real = sum(i is not None and i is not Ellipsis for i in idx)
    dim, tensors = 0, {}
    for i in idx:
        if i is Ellipsis:
            dim += x.ndim - real
        elif i is None:
            x = torch.ops.aten.unsqueeze.default(x, dim)
            dim += 1
        elif isinstance(i, int):
            x = torch.ops.aten.select.int(x, dim, i)
        elif isinstance(i, slice):
            if i != slice(None):
                x = torch.ops.aten.slice.Tensor(x, dim, i.start, i.stop,
                                                i.step or 1)
            dim += 1
        else:
            tensors[dim] = i
            dim += 1
    if tensors:
        x = torch.ops.aten.index.Tensor(
            x, [tensors.get(d) for d in range(max(tensors) + 1)])
    return x


class _GuardFree(torch.overrides.TorchFunctionMode):
    """The three Tensor methods whose Python bindings open a device guard,
    run by their aten ops: a CPU-only build has no CUDA guard for a fake
    ``cuda`` tensor."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.Tensor.contiguous:
            fmt = kwargs.get("memory_format", torch.contiguous_format)
            if args[0].is_contiguous(memory_format=fmt):
                return args[0]
            return torch.ops.aten.clone.default(args[0], memory_format=fmt)
        if func is torch.Tensor.copy_:
            return torch.ops.aten.copy_.default(*args, **kwargs)
        if func is torch.Tensor.__getitem__:
            return _getitem(*args)
        return func(*args, **kwargs)


class _KernelOps(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the ``repro_torch::`` ops dispatched."""

    def __init__(self):
        super().__init__()
        self.seen: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._overloadpacket._qualified_op_name
        if name.startswith("repro_torch::"):
            self.seen[name] = self.seen.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


KERNEL_CELL = """
import json, sys
import torch.distributed as dist
from repro_torch.launch import dryrun
out = [dryrun.run_cell("yi-9b", "decode_32k", False, "auto",
                       {"n_layers": 1, "use_kernel": k}) for k in (True, False)]
dist.destroy_process_group()
print(json.dumps(out))
"""


def test_use_kernel_cell_traces_the_kernel_ops(tmp_path):
    """``use_kernel=True`` traces the hand kernels' custom ops on fake
    ``cuda`` tensors, launching and counting nothing.  The meshless yi-9b
    SMOKE ``lln_diag`` forward, prefill and decode (kernel backend) reach
    the forward and decode ops' fakes.  Where torch is built with CUDA, the
    yi-9b ``decode_32k`` cell on 16 x 16 is ``ok`` with the argument bytes
    of the ``use_kernel=False`` cell; on a CPU-only build the cell is
    refused before any group starts, naming the ops that need a CUDA
    guard (``launch/dryrun.py``), and the CLI writes ``ok: false``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs import get_config
    la = importlib.import_module("repro_torch.kernels.lln_attention")
    from repro_torch.kernels import block_diag as bd
    cfg = get_config("yi-9b", smoke=True, attn_impl="lln_diag",
                     use_kernel=True, attn_backend="kernel")
    counters = (la.lln_causal, la.lln_decode, la.lln_diag_fused,
                bd.block_diag)
    before = [f.launches for f in counters]
    ops = _KernelOps()
    with FakeTensorMode(), _GuardFree(), torch.no_grad(), ops:
        model = build_model(cfg, "cuda")
        params = model.init(None)
        toks = torch.zeros(2, 32, dtype=torch.int64, device="cuda")
        h, _ = model.hidden(params, {"inputs": toks})
        assert tuple(h.shape) == (2, 32, cfg.d_model)
        with torch.inference_mode():
            _, caches = model.prefill(params, {"inputs": toks}, 40)
            logits, _ = model.decode(params, caches, toks[:, 0], 32)
        assert logits.device.type == "cuda"
    assert {"repro_torch::lln_diag_fused", "repro_torch::lln_causal",
            "repro_torch::block_diag", "repro_torch::lln_decode"} \
        <= set(ops.seen), ops.seen
    assert [f.launches for f in counters] == before
    if torch.backends.cuda.is_built():
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        proc = subprocess.run([sys.executable, "-c", KERNEL_CELL],
                              capture_output=True, text=True, env=env,
                              timeout=600, cwd=ROOT)
        assert proc.returncode == 0, proc.stderr[-4000:]
        kern, core = json.loads(proc.stdout.strip().splitlines()[-1])
        assert kern["ok"] and core["ok"]
        assert kern["argument_size_in_bytes"] == \
            core["argument_size_in_bytes"]
        return
    with pytest.raises(RuntimeError, match="shard_dim_alltoall"):
        dryrun.run_cell("yi-9b", "decode_32k", False,
                        overrides={"use_kernel": True, "n_layers": 1})
    assert not torch.distributed.is_initialized()
    rc = dryrun.main(["--arch", "yi-9b", "--shape", "decode_32k",
                      "--override", "use_kernel=True,n_layers=1", "--out",
                      str(tmp_path)])
    assert rc == 1 and not torch.distributed.is_initialized()
    got = json.loads((tmp_path / "yi-9b__decode_32k__16x16.json")
                     .read_text())
    assert not got["ok"] and "CPU-only" in got["error"]


def _duck(shape, names):
    return SimpleNamespace(axis_names=names,
                           devices=SimpleNamespace(shape=shape))


def _flat(tree) -> dict:
    return {j_shd._path_str(kp): leaf for kp, leaf in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))[0]}


def _local_bytes(shape, dtype, spec, sizes) -> int:
    """One rank's bytes of a leaf under the (trailing dims of) ``spec``."""
    spec = tuple(spec)[len(tuple(spec)) - len(shape):]
    n = 1
    for dim, axes in zip(shape, spec):
        axes = () if axes is None else (
            axes if isinstance(axes, tuple) else (axes,))
        n *= dim // math.prod(sizes[a] for a in axes)
    return n * torch.empty((), dtype=dtype).element_size()


def _ref_path(port_path: str) -> str:
    return "/".join(p for p in port_path.split("/") if not p.isdigit())


def _expected_bytes(arch, shape_name, over, mesh) -> int:
    """The port's step arguments' per-rank bytes under the reference's
    rules: parameters (and AdamW moments) by ``param_specs``, caches by
    ``cache_shardings``, the batch or token by ``batch_struct``'s specs."""
    shape = SHAPES_BY_NAME[shape_name]
    cfg, _, _ = dryrun.cell_config(arch, shape_name, overrides=over)
    duck = _duck(*MESHES[mesh])
    sizes = dict(zip(MESHES[mesh][1], MESHES[mesh][0]))
    multi_pod = len(sizes) == 3
    jcfg = j_get_config(arch, attn_impl=cfg.attn_impl, **over)
    jm = j_build_model(jcfg)
    jparams = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    rules = j_shd.make_rules(jcfg, multi_pod=multi_pod,
                             serve=shape.kind != "train")
    with FakeTensorMode():
        model = build_model(cfg, "cpu")
        params = model.init(None)
        total = 0
        if shape.kind == "train":
            specs = _flat(j_shd.param_specs(
                {"params": jparams, "opt": j_adamw_init(jparams)}, duck))
            for name, p in params.named_parameters():
                rp = _ref_path(name.replace(".", "/")).replace(
                    "embed_table", "embed/table")
                total += _local_bytes(p.shape, p.dtype,
                                      specs[f"params/{rp}"], sizes)
                total += 2 * _local_bytes(p.shape, torch.float32,
                                          specs[f"opt/m/{rp}"], sizes)
            total += 4                                   # the step, int32
            b, n = shape.global_batch, shape.seq_len
            spec = j_shd.fit_spec(jax.sharding.PartitionSpec(
                rules["act_batch"], rules["act_seq"]), (b, n), duck)
            total += 2 * _local_bytes((b, n), torch.int64, spec, sizes)
            total += _local_bytes((b, n), torch.float32, spec, sizes)
            return total
        specs = _flat(j_shd.param_specs(jparams, duck))
        for name, p in params.named_parameters():
            rp = _ref_path(name.replace(".", "/")).replace(
                "embed_table", "embed/table")
            total += _local_bytes(p.shape, p.dtype, specs[rp], sizes)
        b, n = shape.global_batch, shape.seq_len
        caches = model.cache_init(None, b, n)
        jcaches = jax.eval_shape(lambda: jm.cache_init(jparams, b, n))
        with mock.patch.object(j_steps, "NamedSharding",
                               lambda m, spec: spec):
            cspecs = _flat(j_steps.cache_shardings(jcaches, jcfg, duck,
                                                   rules))
        for kp, leaf in leaves_with_path(caches):
            total += _local_bytes(leaf.shape, leaf.dtype,
                                  cspecs[_ref_path(path_str(kp))], sizes)
        spec = j_shd.fit_spec(jax.sharding.PartitionSpec(
            rules["act_batch"]), (b,), duck)
        return total + _local_bytes((b,), torch.int64, spec, sizes)


def _child(job):
    mesh, cells = job
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, json.dumps(cells),
         "1" if mesh == "2x16x16" else "0"],
        capture_output=True, text=True, env=env, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def cells():
    """The children, run at once: one for 16 x 16, two for 2 x 16 x 16
    (whose DTensor ops cost about 3x more to place), each with a group of
    its own."""
    half = len(CELLS) // 2
    jobs = [("16x16", CELLS), ("2x16x16", CELLS[:half]),
            ("2x16x16", CELLS[half:])]
    with ThreadPoolExecutor(len(jobs)) as pool:
        out = list(pool.map(_child, jobs))
    return {"16x16": out[0], "2x16x16": out[1] + out[2]}


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_one_cell_per_family_on_the_production_meshes(cells, mesh):
    for (arch, shape, over), got in zip(CELLS, cells[mesh]):
        assert got["ok"], (arch, got)
        assert got["devices"] == math.prod(MESHES[mesh][0])
        assert got["mesh"] == mesh and got["shape"] == shape
        assert got["argument_size_in_bytes"] == _expected_bytes(
            arch, shape, over, mesh), (arch, shape)
        assert got["lower_s"] >= 0 and got["flops"] > 0
        assert got["collectives"], (arch, got)
