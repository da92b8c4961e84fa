"""Multi-rank checks of the port on the CPU: gloo process groups in spawned
processes.

``spawn(target, world, tmp_path, *args)`` starts ``world`` fresh processes
(the ``spawn`` start method: a pytest worker is reused across files, so no
group may live in it), each with one torch thread, a gloo group over a
``FileStore`` under ``tmp_path`` (parallel workers never share a port) and
the port's modules only.  Rank r calls ``target(rank, world, *args)``,
where ``target`` is ``"module:function"`` importable in the child; the
group is destroyed before the process ends, and each rank's return value
comes back (through ``torch.save``) as the list ``[rank 0, rank 1, ...]``.
A rank that raises fails the call with its traceback.

Run as a script (``PYTHONPATH=src python tests/_torch_dist.py``) it holds
the same mesh (2, 2) runs (item 12a's, and item 12b's family cases) to the
port's own meshless runs, with weights from the port's seeded init
instead of the reference's: a check of the mesh path on a machine without
JAX (such as the card's host, on its CPU).
"""
from __future__ import annotations

import contextlib
import importlib
import multiprocessing as mp
import os
import traceback


def _entry(rank: int, world: int, store: str, target: str, args: tuple,
           out: str) -> None:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(store, world), rank=rank,
            world_size=world)
        mod, _, fn = target.partition(":")
        result = getattr(importlib.import_module(mod), fn)(rank, world,
                                                           *args)
        torch.save({"ok": result}, out)
    except Exception:            # reported to the parent with its traceback
        torch.save({"error": traceback.format_exc()}, out)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(target: str, world: int, tmp_path, *args, timeout: float = 300):
    import torch
    ctx = mp.get_context("spawn")
    tag = f"{target.replace(':', '_').replace('.', '_')}_{world}"
    store = os.path.join(str(tmp_path), f"{tag}.store")
    outs = [os.path.join(str(tmp_path), f"{tag}.{r}.pt")
            for r in range(world)]
    procs = [ctx.Process(target=_entry,
                         args=(r, world, store, target, args, outs[r]))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    results = []
    for r, path in enumerate(outs):
        if not os.path.exists(path):
            raise RuntimeError(f"rank {r} of {target} left no result "
                               f"(exit code {procs[r].exitcode})")
        got = torch.load(path, weights_only=False)
        if "error" in got:
            raise RuntimeError(f"rank {r} of {target} failed:\n"
                               f"{got['error']}")
        results.append(got["ok"])
    return results


# ---------------------------------------------------------------------------
# Rank functions of tests/test_torch_distributed.py (torch and the port
# only: the reference runs in the test's own process).
# ---------------------------------------------------------------------------

def _mesh(data: int, model: int):
    from repro_torch.launch.mesh import make_smoke_mesh
    return make_smoke_mesh(data, model, device="cpu")


def _check_local_shapes(tree, shardings) -> int:
    """Every DTensor leaf of ``tree`` is placed as ``shardings`` says and
    its local shape is the fitted spec's shard; returns the number of
    leaves split on some mesh dim."""
    from torch.distributed.tensor import Shard
    from repro_torch.tree import leaves_with_path, path_str
    split = 0
    for kp, a in leaves_with_path(tree):
        sh = shardings[path_str(kp)]
        assert tuple(a.placements) == sh.placements, (path_str(kp),
                                                      a.placements)
        want = list(a.shape)
        for i, pl in enumerate(a.placements):
            if isinstance(pl, Shard):
                want[pl.dim] //= a.device_mesh.size(i)
        assert tuple(a.to_local().shape) == tuple(want), (path_str(kp),
                                                          want)
        split += tuple(want) != tuple(a.shape)
    return split


def _params(params_np, cfg):
    """The reference's weights converted, or (None) the port's seeded
    init."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.models import build_model
    if params_np is None:
        return build_model(cfg, "cpu").init(0)
    return params_from_numpy(params_np, cfg, "cpu")


def train_on_mesh(rank, world, cases, ckpt_dir):
    """For each (arch, impl, overrides, state numpy, batches numpy, lr,
    total steps): ``make_train_setup(mesh=(2, 2))`` from the converted
    state.  Returns (per case: losses, grad norms, the params and moments
    after the steps as numpy, split leaves) and the train CLI's losses
    under ``--mesh 2,2``."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.convert import train_state_from_numpy
    from repro_torch.data import torch_placer
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import train
    from repro_torch.launch.steps import make_train_setup
    mesh = _mesh(2, 2)
    out = []
    for arch, impl, over, state_np, batches, lr, total in cases:
        cfg = get_config(arch, smoke=True, attn_impl=impl,
                         compute_dtype="float32", **over)
        b, n = batches[0]["inputs"].shape
        setup = make_train_setup(cfg, ShapeSpec("t", n, b, "train"),
                                 mesh=mesh, peak_lr=lr, total_steps=total)
        state = setup.init_state(0) if state_np is None \
            else train_state_from_numpy(state_np, cfg, "cpu")
        shardings = setup.state_shardings(state)
        state = shd.shard_tree(state, shardings)
        split = _check_local_shapes(state, shardings)
        place = torch_placer("cpu")
        losses, norms = [], []
        for batch in batches:
            state, m = setup.step_fn(state, place(batch))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        _check_local_shapes(state, shardings)
        full = {"params": {k: p.full_tensor().detach().numpy()
                           for k, p in state["params"].named_parameters()},
                "m": {k: t.full_tensor().numpy()
                      for k, t in state["opt"]["m"].items()},
                "v": {k: t.full_tensor().numpy()
                      for k, t in state["opt"]["v"].items()}}
        out.append({"loss": losses, "grad_norm": norms, "split": split,
                    **(full if rank == 0 else {})})
    hist = train.main(["--arch", "yi-9b", "--smoke", "--attn-impl",
                       "lln_diag", "--device", "cpu", "--steps", "2",
                       "--batch", "2", "--seq", "16", "--mesh", "2,2",
                       "--ckpt-dir", ckpt_dir, "--ckpt-interval", "1"])
    return out, [h["loss"] for h in hist]


def serve_on_mesh(rank, world, cases, capacity_factor, ckpt_dir,
                  pool_cases=(), spec_case=None):
    """For each (arch, impl, overrides, params numpy, batch numpy,
    max_len, steps, pos0): ``make_serve_setup(mesh=(2, 2))``, prefill and
    greedy decode; the caches' local shapes checked after every step.
    Returns ``{"serve": [tokens (prefill's first) and the split cache
    leaves per case], "moe": moe_on_mesh's, "elastic": elastic_save's
    for the first case, "placer": placer_on_mesh's, "items": pool_on_mesh's
    and "batcher": batcher_on_mesh's}`` (the last two with ``spec_case``)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed.elastic import make_degraded_mesh
    from repro_torch.launch.steps import make_serve_setup
    mesh = _mesh(2, 2)
    out = []
    for arch, impl, over, params_np, batch_np, max_len, steps, pos0 in cases:
        cfg = get_config(arch, smoke=True, attn_impl=impl,
                         compute_dtype="float32", **over)
        bsz = batch_np["inputs"].shape[0]
        setup = make_serve_setup(cfg, ShapeSpec("s", max_len, bsz, "decode"),
                                 mesh=mesh)
        params = setup.shard_params(_params(params_np, cfg))
        batch = {k: torch.from_numpy(np.asarray(v).astype(np.int64))
                 for k, v in batch_np.items() if k == "inputs"}
        logits, caches = setup.prefill_fn(params, batch)
        split = _check_local_shapes(caches, setup.cache_shardings(caches))
        tok = torch.argmax(logits[:, -1], -1)
        toks = [tok]
        for i in range(steps):
            logits, caches = setup.decode_fn(params, caches, tok, pos0 + i)
            _check_local_shapes(caches, setup.cache_shardings(caches))
            tok = torch.argmax(logits, -1)
            toks.append(tok)
        out.append({"tokens": torch.stack(toks, 1).numpy(), "split": split})
    arch, impl, over, params_np, batch_np, max_len, steps, pos0 = cases[0]
    degraded = make_degraded_mesh([0, 1, 2], prefer_model=16, device="cpu")
    res = {"serve": out, "moe": moe_on_mesh(mesh, capacity_factor),
           "elastic": elastic_save(mesh, degraded, arch, impl, params_np,
                                   batch_np, max_len, steps, pos0,
                                   ckpt_dir),
           "placer": placer_on_mesh(mesh)}
    if spec_case is not None:
        res["items"] = pool_on_mesh(mesh, degraded, pool_cases, spec_case)
        res["batcher"] = batcher_on_mesh(pool_cases[0]["params"])
    return res


def placer_on_mesh(mesh):
    """``data/pipeline.py:device_placer`` against ``mesh_placer`` on a
    numpy batch: each entry's placements and local shard."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import device_placer, mesh_placer
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import steps
    cfg = get_config("yi-9b", smoke=True)
    shape = ShapeSpec("t", 16, 4, "train")
    struct = steps.batch_struct(cfg, shape, mesh, shd.make_rules(
        cfg, multi_pod=False))
    batch = {"inputs": np.arange(64).reshape(4, 16),
             "mask": np.ones((4, 16), np.float32)}
    got = device_placer(mesh, {k: v.spec for k, v in struct.items()})(batch)
    want = mesh_placer(mesh, steps.batch_placements(struct, mesh))(batch)
    return {k: (tuple(got[k].placements) == tuple(want[k].placements)
                and torch.equal(got[k].to_local(), want[k].to_local())
                and got[k].to_local().shape[0] == 2)
            for k in batch}


def batcher_on_mesh(params_np):
    """The request pool's engine (``launch/batcher.py``) with speculative
    rows on the mesh the CLIs' flag gives (``mesh_from_flag("2,2",
    continuous=True, speculative=True)``) and without one: each request's
    tokens and status (every rank's batcher must decide the same)."""
    import numpy as np
    from repro_torch.launch.batcher import ContinuousBatcher, Request
    from repro_torch.launch.mesh import mesh_from_flag
    case = {"arch": "elastic", "params": params_np, "spec_k": 2,
            "draft_layers": 1}
    mesh = mesh_from_flag("2,2", _pool_cfg(case), "cpu", continuous=True,
                          speculative=True)
    rng = np.random.default_rng(3)
    reqs = [Request(rid=i, prompt=rng.integers(0, 128, 8).astype(np.int32),
                    gen_len=g) for i, g in enumerate((3, 6, 2, 5))]
    out = {}
    for tag, m in (("mesh", mesh), ("meshless", None)):
        setup, params, _ = pool_case(case, m)
        stats = ContinuousBatcher(setup, params).run(reqs)
        out[tag] = {"outputs": {k: [int(t) for t in v]
                                for k, v in stats.outputs.items()},
                    "statuses": dict(stats.statuses)}
    return out


def moe_on_mesh(mesh, capacity_factor):
    """qwen3-moe SMOKE's first MoE block through the expert-parallel path
    on (2, 2) against its meshless path on the same rank: a prefill-shaped
    input (n = 16: reduce-scatter onto the sequence) and a decode-shaped
    one (n = 1: all-reduce), with the collectives ``CommDebugMode``
    counts; then a train step's loss on the mesh and without it."""
    import torch
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.launch.steps import make_train_setup
    from repro_torch.models import build_model, synthetic_batch
    from repro_torch.models import moe as moe_mod
    cfg = get_config("qwen3-moe-235b-a22b", smoke=True,
                     compute_dtype="float32",
                     capacity_factor=capacity_factor)
    params = build_model(cfg, "cpu").init(0)
    gen = torch.Generator().manual_seed(0)
    xs = {"prefill": torch.randn(4, 16, cfg.d_model, generator=gen),
          "decode": torch.randn(4, 1, cfg.d_model, generator=gen)}
    want = {k: moe_mod.moe_apply(params.layers[0].moe, x, cfg)[0]
            for k, x in xs.items()}
    rules = shd.make_rules(cfg, multi_pod=False)
    shd.shard_tree(params, shd.param_shardings(params, mesh))
    out = {}
    with torch.no_grad(), shd.logical_rules(mesh, rules):
        for k, x in xs.items():
            xd = distribute_tensor(x, mesh, shd.spec_placements(
                x.shape, ("act_batch", "act_seq", "embed")),
                src_data_rank=None)
            with CommDebugMode() as comm:
                got, _ = moe_mod.moe_apply(params.layers[0].moe, xd, cfg)
            out[k] = {"err": float((got.full_tensor() - want[k]).abs().max()),
                      "scale": float(want[k].abs().max()),
                      "placements": tuple(str(p) for p in got.placements),
                      "comm": {str(op): n for op, n in
                               comm.get_comm_counts().items()}}
    # A train step without and with the mesh, and the aux loss of its
    # params: on the mesh the aux is the mean of the shards' (as in the
    # reference), so the step losses agree once it is taken out.
    tcfg = cfg.replace(grad_accum=1)
    shape = ShapeSpec("t", 16, 4, "train")
    batch = synthetic_batch(tcfg, 4, 16, seed=1, device="cpu")
    out["train"] = []
    for mesh_ in (None, mesh):
        setup = make_train_setup(tcfg, shape, "cpu", mesh=mesh_,
                                 peak_lr=1e-3, total_steps=3)
        state = setup.init_state(0)
        placed, rules = batch, contextlib.nullcontext()
        if mesh_ is not None:
            placed = steps.place_batch(batch, steps.batch_struct(
                tcfg, shape, mesh_, setup.rules), mesh_)
            rules = shd.logical_rules(mesh_, setup.rules)
        with torch.no_grad(), rules:
            _, aux = setup.model.hidden(state["params"], placed)
        _, m = setup.step_fn(state, batch)
        out["train"].append((float(m["loss"]), float(
            aux.full_tensor() if shd.is_dtensor(aux) else aux)))
    out["aux_coef"] = tcfg.router_aux_coef
    return out


def elastic_save(mesh, degraded, arch, impl, params_np, batch_np, max_len,
                 steps, pos0, ckpt_dir):
    """World 4, mesh (2, 2): prefill, save ``{"params", "caches"}`` (each
    leaf gathered, rank 0 writes), then ``steps`` greedy decode steps.
    Returns the tokens and ``degraded``, the mesh over 3 surviving
    ranks."""
    import numpy as np
    import torch
    from repro_torch.checkpoint import checkpointer as ck
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.steps import make_serve_setup
    cfg = get_config(arch, smoke=True, attn_impl=impl,
                     compute_dtype="float32")
    bsz = batch_np["inputs"].shape[0]
    setup = make_serve_setup(cfg, ShapeSpec("s", max_len, bsz, "decode"),
                             mesh=mesh)
    params = setup.shard_params(_params(params_np, cfg))
    logits, caches = setup.prefill_fn(
        params, {"inputs": torch.from_numpy(batch_np["inputs"].astype(
            np.int64))})
    tok = torch.argmax(logits[:, -1], -1)
    ck.save(ckpt_dir, 1, {"params": params, "caches": caches,
                          "tok": tok})
    toks, caches = setup.make_generate(steps)(params, caches, tok, pos0)
    return {"tokens": toks.numpy(),
            "degraded": (tuple(degraded.mesh.shape),
                         degraded.get_coordinate() is not None)}


def elastic_restore(rank, world, arch, impl, max_len, batch, steps, pos0,
                    ckpt_dir):
    """World 2 restart on (2, 1) (``make_degraded_mesh`` preferring model
    = 1): restore the world-4 checkpoint with the new mesh's shardings,
    check every leaf against a plain restore bit for bit, then decode
    ``steps`` greedy steps.  Returns the tokens and the mesh's shape."""
    import torch
    from repro_torch.checkpoint import checkpointer as ck
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.elastic import make_degraded_mesh
    from repro_torch.launch.steps import make_serve_setup
    from repro_torch.tree import leaves_with_path, path_str
    cfg = get_config(arch, smoke=True, attn_impl=impl,
                     compute_dtype="float32")
    mesh = make_degraded_mesh(prefer_model=1, device="cpu")
    setup = make_serve_setup(cfg, ShapeSpec("s", max_len, batch, "decode"),
                             mesh=mesh)
    model = setup.model
    plain = {"params": model.init(0),
             "caches": model.cache_init(None, batch, max_len),
             "tok": torch.zeros(batch, dtype=torch.int64)}
    template = {"params": setup.shard_params(model.init(0)),
                "caches": plain["caches"], "tok": plain["tok"]}
    shardings = {**{f"params/{k}": v for k, v in shd.param_shardings(
        template["params"], mesh).items()},
        **{f"caches/{k}": v for k, v in setup.cache_shardings(
            plain["caches"]).items()},
        "tok": shd.NamedSharding(mesh, shd.P(None))}
    got = ck.restore(ckpt_dir, 1, template, shardings)
    want = dict(leaves_with_path(ck.restore(ckpt_dir, 1, plain)))
    for kp, a in leaves_with_path(got):
        assert torch.equal(a.full_tensor(), want[kp]), path_str(kp)
    _check_local_shapes(got, shardings)
    toks, _ = setup.make_generate(steps)(
        got["params"], got["caches"], got["tok"].full_tensor(), pos0)
    return {"tokens": toks.numpy(), "mesh": tuple(mesh.mesh.shape)}


# ---------------------------------------------------------------------------
# Item 12c: the request pool and speculative decoding on a mesh.
# ---------------------------------------------------------------------------

# The reference's elastic pool test's config (tests/test_distributed.py).
ELASTIC = dict(name="elastic-pool", family="dense", n_layers=2, d_model=64,
               n_heads=4, n_kv_heads=2, d_ff=128, vocab=128, head_dim=16,
               attn_impl="lln_diag", diag_block=8, lln_chunk=8,
               softmax_chunk=16, lln_fixed_ab=2.1, compute_dtype="float32",
               param_dtype="float32", remat="none", tie_embeddings=True)
POOL = {"slots": 2, "max_len": 32, "segment": 4}


def pool_schedule(vocab: int, seed: int = 1) -> dict:
    """Two 8-token prompts admitted as one group into slots 0 and 1, with
    their next tokens, positions and budgets (the reference test's token 7
    in slot 0)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return {"prompts": rng.integers(0, vocab, (2, 8)).astype(np.int32),
            "tok": [7, 11], "pos": [8, 8], "remaining": [4, 2]}


def _pool_caches(setup, params, sched):
    import torch
    _, slot = setup.prefill_fn(params, torch.from_numpy(
        sched["prompts"].astype("int64")))
    return setup.admit_fn(setup.cache_init(), slot, [0, 1])


def _carry(sched):
    import torch
    return (torch.tensor(sched["tok"]), torch.tensor(sched["pos"],
                                                     dtype=torch.int32),
            torch.tensor(sched["remaining"], dtype=torch.int32),
            torch.tensor([True, True]))


def _segment(setup, params, caches, sched) -> dict:
    """One segment from the schedule's carry: the (S, B[, k+1]) tokens,
    the emitted counts and the sentinel's flags, as numpy."""
    out = setup.segment_fn(params, caches, *_carry(sched))
    return {"tokens": out[5].numpy(), "emitted": out[6].numpy(),
            "unhealthy": out[7].numpy()}


def _pool_cfg(case):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ArchConfig
    if case["arch"] == "elastic":
        return ArchConfig(**ELASTIC)
    return get_config(case["arch"], smoke=True, compute_dtype="float32")


def pool_case(case, mesh):
    """One pool case (``case``: arch "elastic" or a SMOKE arch, its
    weights as numpy or None, ``spec_k``, ``draft_layers``) on ``mesh`` or
    without one (None): one segment after admitting the schedule."""
    from repro_torch.launch.steps import make_pool_setup
    cfg = _pool_cfg(case)
    setup = make_pool_setup(cfg, "cpu", **POOL, spec_k=case["spec_k"],
                            draft_layers=case["draft_layers"], mesh=mesh)
    params = setup.shard_params(_params(case["params"], cfg))
    sched = pool_schedule(cfg.vocab)
    return setup, params, sched


def pool_on_mesh(mesh, degraded, cases, spec_case):
    """Item 12c on (2, 2): each pool case's segment on the mesh and
    without it; for the first case, the pool caches and the parameters
    resharded onto ``degraded`` (``reshard_state``: the (1, 2) sub-mesh of
    ranks 0 and 1, the others idle) and the same segment there; then
    ``make_spec_setup`` greedy tokens on the mesh and without it
    (``spec_case``: a serve case's weights, batch, steps and position)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed.elastic import reshard_state
    from repro_torch.launch.steps import flatten_spec_tokens, make_spec_setup
    out = {"pool": {}}
    for case in cases:
        runs = {}
        for tag, m in (("mesh", mesh), ("meshless", None)):
            setup, params, sched = pool_case(case, m)
            caches = _pool_caches(setup, params, sched)
            runs[tag] = _segment(setup, params, caches, sched)
            if tag == "mesh" and case.get("degrade"):
                caches = _pool_caches(setup, params, sched)
                params2 = reshard_state(params, degraded)
                caches2 = reshard_state(caches, degraded)
                if degraded.get_coordinate() is not None:
                    setup2, _, _ = pool_case(case, degraded)
                    runs["degraded"] = _segment(setup2, params2, caches2,
                                                sched)
        out["pool"][case["name"]] = runs
    arch, impl, params_np, batch_np, max_len, steps, pos0 = spec_case
    cfg = get_config(arch, smoke=True, attn_impl=impl,
                     compute_dtype="float32")
    out["spec"] = {}
    for tag, m in (("mesh", mesh), ("meshless", None)):
        setup = make_spec_setup(cfg, ShapeSpec("s", max_len + 4, 2,
                                               "decode"), "cpu", spec_k=3,
                                draft_layers=1, mesh=m)
        params = setup.shard_params(_params(params_np, cfg))
        logits, tgt, dr = setup.prefill_fn(params, {"inputs": torch.from_numpy(
            np.asarray(batch_np["inputs"]).astype(np.int64))})
        tok = torch.argmax(logits[:, -1], -1)
        toks, n_emit, *_ = setup.make_generate(steps)(params, tgt, dr, tok,
                                                      pos0)
        out["spec"][tag] = np.concatenate(
            [tok[:, None].numpy(), flatten_spec_tokens(toks, n_emit, steps)],
            1)
    return out


def flat_pool_tokens(run: dict) -> list:
    """Each row's emitted tokens of one segment, in order (a plain pool's
    (S, B) tokens and bool mask, or a speculative pool's (S, B, k+1)
    tokens and counts)."""
    toks, emitted = run["tokens"], run["emitted"]
    if toks.ndim == 2:
        toks, emitted = toks[..., None], emitted.astype(int)
    return [[int(t) for s in range(toks.shape[0])
             for t in toks[s, r, :int(emitted[s, r])]]
            for r in range(toks.shape[1])]


# ---------------------------------------------------------------------------
# Item 12b's family cases (tests/test_torch_mesh_families.py and main()).
# ---------------------------------------------------------------------------

PROMPT, STEPS, SRC, LR, TOTAL = 12, 5, 16, 1e-3, 3
CF = {"capacity_factor": 4.0}          # deepseek-v2 SMOKE: E / k, no drop

# (name, arch, impl, overrides): against the meshless port and the
# reference, from the reference's weights.
SERVE = (("mamba2-130m", "mamba2-130m", "softmax", {}),
         ("zamba2-7b", "zamba2-7b", "lln_diag", {}),
         ("deepseek-v2-236b", "deepseek-v2-236b", "softmax", CF),
         ("seamless-m4t-medium", "seamless-m4t-medium", "lln_diag", {}),
         ("paligemma-3b", "paligemma-3b", "softmax", {}),
         ("paligemma-3b lln_diag", "paligemma-3b", "lln_diag", {}),
         ("yi-9b log_linear", "yi-9b", "log_linear", {}))
# Against the meshless port only, from the port's seeded weights (the
# meshless port is held to the reference by the family files): the shared
# block's softmax decode with its kv heads split.
SERVE_PORT = (("zamba2-7b softmax", "zamba2-7b", "softmax", {}),)
TRAIN = (("mamba2-130m", "mamba2-130m", "softmax", {}),
         ("zamba2-7b", "zamba2-7b", "lln_diag", {}),
         ("deepseek-v2-236b", "deepseek-v2-236b", "softmax",
          {**CF, "router_aux_coef": 0.0}),
         ("seamless-m4t-medium", "seamless-m4t-medium", "lln_diag", {}),
         ("paligemma-3b", "paligemma-3b", "softmax", {}),
         ("roberta-lln", "roberta-lln", "lln_diag", {}),
         ("yi-9b log_linear", "yi-9b", "log_linear", {}))
ATTN = ("roberta-lln mask", "yi-9b alpha-beta")


def _serve_batch(cfg, rng) -> dict:
    import numpy as np
    b = {"inputs": rng.integers(0, cfg.vocab, (2, PROMPT)).astype(np.int32)}
    if cfg.family == "encdec":
        b["src"] = rng.normal(size=(2, SRC, cfg.frontend_dim)).astype(
            np.float32)
    if cfg.family == "vlm":
        b["patches"] = rng.normal(size=(2, cfg.num_prefix_tokens,
                                        cfg.frontend_dim)).astype(np.float32)
    return b


def _serve_inputs(arch, impl, over, seed, params=None):
    """The weights (the reference's, or None: the port's seeded init), the
    batch, ``max_len`` and the first decode position of a serving case."""
    import numpy as np
    from repro_torch.configs import get_config
    cfg = get_config(arch, smoke=True, attn_impl=impl, **over)
    pos0 = PROMPT + (cfg.num_prefix_tokens if cfg.family == "vlm" else 0)
    return {"params": params, "pos0": pos0, "max_len": pos0 + STEPS + 1,
            "batch": _serve_batch(cfg, np.random.default_rng(seed))}


def _port_serve(arch, impl, over, ref):
    """The meshless port's greedy tokens of a serving case."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch.steps import make_serve_setup
    cfg = get_config(arch, smoke=True, attn_impl=impl,
                     compute_dtype="float32", **over)
    setup = make_serve_setup(
        cfg, ShapeSpec("s", ref["max_len"], 2, "decode"), "cpu")
    params = setup.model.init(0) if ref["params"] is None \
        else params_from_numpy(ref["params"], cfg, "cpu")
    logits, caches = setup.prefill_fn(params, _port_batch(ref["batch"]))
    tok = torch.argmax(logits[:, -1], -1)
    toks, _ = setup.make_generate(STEPS)(params, caches, tok, ref["pos0"])
    return torch.cat([tok[:, None], toks], 1).numpy()


def _train_over(over):
    return {"use_kernel": False, "grad_accum": 1, **over}


def family_train_batches(cfg, seed=0, steps=2) -> list:
    """``steps`` numpy batches of 2 x 32 with the family's inputs (the VLM's
    32 count its patches): tokens in the vocab, a loss mask with the last 5
    targets of row 1 off, 48 source frames for the encoder-decoder, the
    VLM's patches (``tests/_torch_families.py:train_batches``'s)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    n = 32 - (cfg.num_prefix_tokens if cfg.family == "vlm" else 0)
    out = []
    for _ in range(3):
        toks = rng.integers(0, cfg.vocab, (2, n + 1)).astype(np.int32)
        mask = np.ones((2, n), np.float32)
        mask[1, -5:] = 0.0
        b = {"inputs": toks[:, :-1], "targets": toks[:, 1:], "mask": mask}
        if cfg.family == "encdec":
            b["src"] = rng.normal(size=(2, 48, cfg.frontend_dim)).astype(
                np.float32)
        if cfg.family == "vlm":
            b["patches"] = rng.normal(size=(
                2, cfg.num_prefix_tokens, cfg.frontend_dim)).astype(
                np.float32)
        out.append(b)
    return out[:steps]


def _port_train(arch, impl, over, state0, batches):
    """The meshless port's losses of a training case (``state0`` None: its
    seeded init)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.convert import train_state_from_numpy
    from repro_torch.data import torch_placer
    from repro_torch.launch.steps import make_train_setup
    cfg = get_config(arch, smoke=True, attn_impl=impl,
                     compute_dtype="float32", **_train_over(over))
    n = batches[0]["inputs"].shape[1] + (
        cfg.num_prefix_tokens if cfg.family == "vlm" else 0)
    setup = make_train_setup(cfg, ShapeSpec("t", n, 2, "train"), "cpu",
                             peak_lr=LR, total_steps=TOTAL)
    state = setup.init_state(0) if state0 is None \
        else train_state_from_numpy(state0, cfg, "cpu")
    place = torch_placer("cpu")
    out = []
    for batch in batches:
        state, m = setup.step_fn(state, place(batch))
        out.append(float(m["loss"]))
    return out


def _attn_arrays(name):
    """q, k, v of a SMOKE layer's geometry, with a key mask (bidirectional)
    or given alpha / beta (causal)."""
    import numpy as np
    from repro_torch.configs import get_config
    rng = np.random.default_rng(7)
    arch = name.split()[0]
    cfg = get_config(arch, smoke=True)
    b, n = (4, 32) if arch == "roberta-lln" else (2, 32)
    h, g, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd

    def normal(*shape):
        return rng.normal(size=shape).astype(np.float32)
    out = {"q": normal(b, n, h, d), "k": normal(b, n, g, d),
           "v": normal(b, n, g, d)}
    if name.endswith("mask"):
        mask = np.ones((b, n), bool)
        mask[1, -7:] = False
        mask[3, :5] = False
        out.update(mask=mask, causal=np.asarray(False))
    else:
        out.update(alpha=rng.uniform(0.5, 1.5, h).astype(np.float32),
                   beta=rng.uniform(0.5, 1.5, g).astype(np.float32),
                   causal=np.asarray(True))
    return arch, out


def _port_batch(batch_np) -> dict:
    """A numpy batch as the port's tensors: int64 tokens, fp32 frames and
    patches."""
    import numpy as np
    import torch
    return {k: torch.from_numpy(np.asarray(v).astype(
        np.int64 if np.asarray(v).dtype.kind in "iu" else np.float32))
        for k, v in batch_np.items()}


def _attn_inputs(arrays, cfg, mesh):
    """q, k, v (and the key mask) of an attention case, placed by the
    rules' constraints of ``attention_block._project_qkv``, whole on every
    rank otherwise (``mesh`` None)."""
    import torch
    from repro_torch.distributed import sharding as shd
    t = {k: torch.from_numpy(v) for k, v in arrays.items()
         if k in ("q", "k", "v", "mask")}
    if mesh is None:
        return t
    axes = {"q": ("act_batch", "attn_seq", "heads", None),
            "k": ("act_batch", None, "kv_heads", None),
            "v": ("act_batch", None, "kv_heads", None),
            "mask": ("act_batch", None)}
    return {k: shd.place_leaf(v, shd.NamedSharding(mesh, shd.fit_spec(
        shd.P(*(shd._ACTIVE.get(a) if isinstance(a, str) else a
                for a in axes[k])), v.shape, mesh)))
        for k, v in t.items()}


def _attention_case(mesh, arch, impl, arrays):
    """One attention call of a family's layer geometry on ``mesh`` (None:
    the meshless port): ``multi_head_attention`` with the case's key
    ``mask`` (bidirectional) or given ``alpha`` / ``beta`` (then also the
    engine's prefill with them).  Returns numpy outputs."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.attention import multi_head_attention
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.attention_block import attn_cfg_of, attn_engine
    cfg = get_config(arch, smoke=True, attn_impl=impl,
                     compute_dtype="float32")
    causal = bool(arrays["causal"])
    rules = shd.make_rules(cfg, multi_pod=False, serve=True)
    ctx = shd.logical_rules(mesh, rules) if mesh is not None \
        else contextlib.nullcontext()
    out = {}

    def whole(t):
        return (t.full_tensor() if shd.is_dtensor(t) else t).numpy()

    with ctx, torch.no_grad():
        t = _attn_inputs(arrays, cfg, mesh)
        ab = {}
        if "alpha" in arrays:
            ab = {"alpha": torch.from_numpy(arrays["alpha"]),
                  "beta": torch.from_numpy(arrays["beta"])}
        out["out"] = whole(multi_head_attention(
            t["q"], t["k"], t["v"], attn_cfg_of(cfg, causal),
            mask=t.get("mask"), **ab))
        if ab:
            o, st = attn_engine(cfg, causal).prefill(
                t["q"], t["k"], t["v"], max_len=arrays["q"].shape[1], **ab)
            out["prefill"] = whole(o)
            for f in ("s", "z", "alpha", "beta"):
                out[f] = whole(getattr(st, f))
    return out


def families_on_mesh(rank, world, serve_cases, train_cases, attn_cases):
    """Item 12b's families on mesh (2, 2).  ``serve_cases``: (name, arch,
    impl, overrides, params numpy or None, batch numpy, max_len, steps,
    pos0): prefill and greedy decode through ``make_serve_setup(mesh=)``,
    the caches' local shapes checked after every step; ``train_cases``:
    (name, arch, impl, overrides, state numpy or None, batches numpy, lr,
    total steps): the losses of ``make_train_setup(mesh=)``;
    ``attn_cases``: (name, arch, impl, arrays): :func:`_attention_case` on
    the mesh and without it.  Returns ``{"serve": {name: {tokens,
    split}}, "train": {name: {loss, split}}, "attn": {name: (mesh,
    meshless)}}``."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.convert import train_state_from_numpy
    from repro_torch.data import torch_placer
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.steps import make_serve_setup, make_train_setup
    mesh = _mesh(2, 2)
    out = {"serve": {}, "train": {}, "attn": {}}
    for name, arch, impl, over, params_np, batch_np, max_len, steps, pos0 \
            in serve_cases:
        cfg = get_config(arch, smoke=True, attn_impl=impl,
                         compute_dtype="float32", **over)
        bsz = batch_np["inputs"].shape[0]
        setup = make_serve_setup(cfg, ShapeSpec("s", max_len, bsz, "decode"),
                                 mesh=mesh)
        params = setup.shard_params(_params(params_np, cfg))
        logits, caches = setup.prefill_fn(params, _port_batch(batch_np))
        split = _check_local_shapes(caches, setup.cache_shardings(caches))
        tok = torch.argmax(logits[:, -1], -1)
        toks = [tok]
        for i in range(steps):
            logits, caches = setup.decode_fn(params, caches, tok, pos0 + i)
            _check_local_shapes(caches, setup.cache_shardings(caches))
            tok = torch.argmax(logits, -1)
            toks.append(tok)
        out["serve"][name] = {"tokens": torch.stack(toks, 1).numpy(),
                              "split": split}
    for name, arch, impl, over, state_np, batches, lr, total in train_cases:
        cfg = get_config(arch, smoke=True, attn_impl=impl,
                         compute_dtype="float32", **over)
        first = batches[0]
        n = first["inputs"].shape[1]
        if cfg.family == "vlm":
            n += cfg.num_prefix_tokens
        setup = make_train_setup(cfg, ShapeSpec("t", n, first[
            "inputs"].shape[0], "train"), mesh=mesh, peak_lr=lr,
            total_steps=total)
        state = setup.init_state(0) if state_np is None \
            else train_state_from_numpy(state_np, cfg, "cpu")
        shardings = setup.state_shardings(state)
        state = shd.shard_tree(state, shardings)
        split = _check_local_shapes(state, shardings)
        place = torch_placer("cpu")
        losses = []
        for batch in batches:
            state, m = setup.step_fn(state, place(batch))
            losses.append(float(m["loss"]))
        _check_local_shapes(state, shardings)
        out["train"][name] = {"loss": losses, "split": split}
    for name, arch, impl, arrays in attn_cases:
        out["attn"][name] = (_attention_case(mesh, arch, impl, arrays),
                             _attention_case(None, arch, impl, arrays))
    return out


def _meshless_tokens(arch, impl, over, batch_np, max_len, steps, pos0):
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.steps import make_serve_setup
    cfg = get_config(arch, smoke=True, attn_impl=impl,
                     compute_dtype="float32", **over)
    setup = make_serve_setup(cfg, ShapeSpec("s", max_len, 2, "decode"),
                             "cpu")
    params = setup.model.init(0)
    logits, caches = setup.prefill_fn(params, {"inputs": torch.from_numpy(
        batch_np["inputs"].astype(np.int64))})
    tok = torch.argmax(logits[:, -1], -1)
    toks, _ = setup.make_generate(steps)(params, caches, tok, pos0)
    return torch.cat([tok[:, None], toks], 1).numpy()


def main() -> int:
    """The mesh (2, 2) checks at world 4 (and the world-2 restart) against
    the port's meshless runs; prints one line per check."""
    import tempfile
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import torch_placer
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.launch.steps import make_train_setup
    torch.set_num_threads(1)
    ok = True

    def report(name, good, detail=""):
        nonlocal ok
        ok = ok and bool(good)
        print(f"mesh check {name}: {'ok' if good else 'FAILED'} {detail}",
              flush=True)

    prompt, steps, max_len = 20, 8, 29
    batch_np = {"inputs": np.random.default_rng(0).integers(
        0, 500, (2, prompt)).astype(np.int32)}
    cases = [(a, i, o, None, batch_np, max_len, steps, prompt)
             for a, i, o in (("yi-9b", "lln_diag", {}),
                             ("qwen3-14b", "softmax", {}),
                             ("yi-9b", "lln_diag", {"n_kv_heads": 1}),
                             ("qwen3-moe-235b-a22b", "lln",
                              {"capacity_factor": 4.0}))]
    pools = [{"name": "elastic", "arch": "elastic", "params": None,
              "spec_k": 0, "draft_layers": 0, "degrade": True},
             {"name": "elastic spec", "arch": "elastic", "params": None,
              "spec_k": 2, "draft_layers": 1},
             {"name": "mamba2", "arch": "mamba2-130m", "params": None,
              "spec_k": 0, "draft_layers": 0}]
    with tempfile.TemporaryDirectory() as tmp:
        ranks = spawn("_torch_dist:serve_on_mesh", 4, tmp, cases,
                      4.0, f"{tmp}/elastic", pools,
                      ("yi-9b", "lln_diag", None, batch_np, max_len, 5,
                       prompt))
        items = ranks[0]["items"]
        for name, runs in items["pool"].items():
            base = flat_pool_tokens(runs["meshless"])
            report(f"pool {name}", all(
                flat_pool_tokens(r) == base and not r["unhealthy"].any()
                for tag, r in runs.items() if tag != "meshless"),
                f"runs {sorted(runs)}")
        report("speculative", np.array_equal(items["spec"]["mesh"],
                                             items["spec"]["meshless"]))
        bat = ranks[0]["batcher"]
        report("batcher", all(r["batcher"] == bat for r in ranks)
               and bat["mesh"] == bat["meshless"]
               and set(bat["mesh"]["statuses"].values()) == {"done"})
        report("device_placer", all(all(r["placer"].values())
                                    for r in ranks))
        for case, got in zip(cases, ranks[0]["serve"]):
            want = _meshless_tokens(*case[:3], batch_np, max_len, steps,
                                    prompt)
            report(f"serve {case[0]} {case[1]} {case[2]}",
                   np.array_equal(got["tokens"], want) and got["split"],
                   f"split cache leaves {got['split']}")
        moe = ranks[0]["moe"]
        for kind in ("prefill", "decode"):
            report(f"moe {kind}", moe[kind]["err"] <= 1e-5 * max(
                moe[kind]["scale"], 1.0), f"{moe[kind]}")
        (l0, a0), (l1, a1) = moe["train"]
        c = moe["aux_coef"]
        report("moe train", abs((l1 - c * a1) - (l0 - c * a0))
               <= 1e-5 * abs(l0), f"{moe['train']}")
        after = spawn("_torch_dist:elastic_restore", 2, tmp, "yi-9b",
                      "lln_diag", max_len, 2, steps, prompt,
                      f"{tmp}/elastic")
        report("elastic", np.array_equal(after[0]["tokens"],
                                         ranks[0]["elastic"]["tokens"]),
               f"mesh {after[0]['mesh']}")
        tcases, want = [], []
        for impl in ("lln_diag", "softmax"):
            cfg = get_config("yi-9b", smoke=True, attn_impl=impl,
                             compute_dtype="float32")
            gen = lm_batches(cfg.vocab, 2, 32, seed=0)
            batches = [next(gen) for _ in range(2)]
            setup = make_train_setup(cfg, ShapeSpec("t", 32, 2, "train"),
                                     "cpu", peak_lr=1e-3, total_steps=3)
            state = setup.init_state(0)
            losses = []
            for b in batches:
                state, m = setup.step_fn(state, torch_placer("cpu")(b))
                losses.append(float(m["loss"]))
            want.append(losses)
            tcases.append(("yi-9b", impl, {}, None, batches, 1e-3, 3))
        got, cli = spawn("_torch_dist:train_on_mesh", 4, tmp, tcases,
                         f"{tmp}/ckpt")[0]
        for (_, impl, *_), g, w in zip(tcases, got, want):
            report(f"train {impl}", all(abs(a - b) <= 1e-5 * abs(b)
                                        for a, b in zip(g["loss"], w)),
                   f"{g['loss']} vs {w}")
        report("train CLI", len(cli) == 2, f"losses {cli}")
        families_main(report, tmp)
    return 0 if ok else 1


def families_main(report, tmp) -> None:
    """Item 12b's family cases on (2, 2) from the port's seeded init,
    against the port's meshless runs (tokens equal, losses and attention
    outputs within 1e-5)."""
    import numpy as np
    from repro_torch.configs import get_config
    serve_in = {name: _serve_inputs(arch, impl, over, i)
                for i, (name, arch, impl, over)
                in enumerate(SERVE + SERVE_PORT)}
    batches = {name: family_train_batches(get_config(
        arch, smoke=True, attn_impl=impl, **_train_over(over)))
        for name, arch, impl, over in TRAIN}
    attn = {name: _attn_arrays(name) for name in ATTN}
    got = spawn("_torch_dist:families_on_mesh", 4, tmp,
                [(name, arch, impl, over, None, serve_in[name]["batch"],
                  serve_in[name]["max_len"], STEPS, serve_in[name]["pos0"])
                 for name, arch, impl, over in SERVE + SERVE_PORT],
                [(name, arch, impl, _train_over(over), None, batches[name],
                  LR, TOTAL) for name, arch, impl, over in TRAIN],
                [(name, arch, "lln_diag", arrays)
                 for name, (arch, arrays) in attn.items()])[0]
    for name, arch, impl, over in SERVE + SERVE_PORT:
        want = _port_serve(arch, impl, over, serve_in[name])
        res = got["serve"][name]
        report(f"family serve {name}", np.array_equal(res["tokens"], want)
               and res["split"], f"split cache leaves {res['split']}")
    for name, arch, impl, over in TRAIN:
        want = _port_train(arch, impl, over, None, batches[name])
        res = got["train"][name]["loss"]
        report(f"family train {name}", all(
            abs(a - b) <= 1e-5 * abs(b) for a, b in zip(res, want)),
            f"{res} vs {want}")
    for name, (mesh_out, plain) in got["attn"].items():
        err = max(float(np.abs(mesh_out[k] - plain[k]).max()) for k in plain)
        scale = max(1.0, max(float(np.abs(v).max()) for v in plain.values()))
        report(f"family attention {name}", err <= 1e-5 * scale,
               f"max abs err {err:.3e}")


if __name__ == "__main__":
    raise SystemExit(main())
