"""The port's continuous-batching pool and its robustness layer, on the CPU.

Mirrors the reference's ``tests/test_batching.py`` and
``tests/test_robustness.py`` at their tiny config (2 layers, d_model 64,
4 heads of 16, vocab 128, fp32):

* the pool (staggered admits and evicts, per-row positions, row masks)
  emits for every request the tokens of that request served alone through
  ``ServeSetup.make_generate``, token for token: ``softmax``, ``lln``,
  ``lln_diag`` and ``log_linear`` at r in {1, 4}, under dynamic
  calibration, and for the ssm and hybrid families at SMOKE size;
* masked rows leave every cache leaf bitwise unchanged, and their logits
  never reach sampling; ``evict`` resets ``alpha``/``beta`` to one; a
  readmitted slot equals a solo run; one admit writes exactly one row;
* the sentinel, quarantine and replay, retries, drops, admission guards,
  the queue cap, deadlines, the watchdog, kill and restore, and the fault
  plans, as the reference's cases;
* one cross-check against the reference pool: the same converted weights
  and traffic at ``lln_diag``, r = 4, dynamic calibration, equal tokens.

Every comparison of tokens is exact (greedy decoding).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread per test worker)

from repro.configs.base import ArchConfig as JArchConfig
from repro.launch.batcher import ContinuousBatcher as JBatcher
from repro.launch.batcher import synthetic_traffic as j_traffic
from repro.launch.mesh import compat_mesh
from repro.launch.steps import make_pool_setup as j_make_pool_setup
from repro.models import build_model as j_build_model
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.convert import params_from_numpy
from repro_torch.core.engine import AttentionEngine
from repro_torch.core.health import HealthConfig, row_health, unhealthy_rows
from repro_torch.kernels.registry import AttnSpec
from repro_torch.launch.batcher import (AdmissionError, ContinuousBatcher,
                                        Request, synthetic_traffic)
from repro_torch.launch.faults import (FaultEvent, FaultPlan, SimulatedCrash,
                                       poison_rows)
from repro_torch.launch.steps import make_pool_setup, make_serve_setup
from repro_torch.tree import leaves_with_path, path_str

_TINY = dict(family="dense", n_layers=2, d_model=64, n_heads=4, d_ff=128,
             vocab=128, head_dim=16, diag_block=8, lln_chunk=8,
             softmax_chunk=16, compute_dtype="float32",
             param_dtype="float32", remat="none", tie_embeddings=True)


def _tiny_cfg(impl="lln_diag", r=2, fixed_ab=False, cls=ArchConfig):
    return cls(name=f"pool-test-{impl}-r{r}", n_kv_heads=4 // r,
               attn_impl=impl,
               lln_fixed_ab=2.1 if fixed_ab and impl != "softmax" else 0.0,
               **_TINY)


def _solo_tokens(setup, params, req, cache):
    """The request served alone: a batch-1 prefill and ``make_generate``,
    with the pool's config (per-row calibration)."""
    if "serve" not in cache:
        cache["serve"] = make_serve_setup(
            setup.cfg, ShapeSpec("solo", setup.max_len, 1, "decode"),
            device="cpu")
    sv = cache["serve"]
    prompt = torch.as_tensor(req.prompt, dtype=torch.long)[None]
    logits, caches = sv.prefill_fn(params, {"inputs": prompt})
    tok = torch.argmax(logits[:, -1], -1)
    out = [int(tok)]
    if req.budget > 1:
        toks, _ = sv.make_generate(req.budget - 1)(params, caches, tok,
                                                   len(req.prompt))
        out += toks[0].tolist()
    return np.asarray(out, np.int32)


def _assert_pool_is_solo(setup, params, reqs, stats):
    cache = {}
    assert stats.admitted == len(reqs)
    for req in reqs:
        got = stats.outputs[req.rid]
        assert len(got) == req.budget
        np.testing.assert_array_equal(got, _solo_tokens(setup, params, req,
                                                        cache),
                                      err_msg=f"rid {req.rid}")


class TestPoolParity:
    @pytest.mark.parametrize("r", [1, 4])
    @pytest.mark.parametrize("impl", ["softmax", "lln", "lln_diag",
                                      "log_linear"])
    def test_pool_matches_solo_generate(self, impl, r):
        """2 slots, 4 mixed-length requests (two leading same-length
        prompts admit as one group): every request equals its solo run."""
        cfg = _tiny_cfg(impl, r, fixed_ab=True)
        setup = make_pool_setup(cfg, "cpu", slots=2, max_len=32, segment=3)
        params = setup.model.init(0)
        reqs = synthetic_traffic(4, cfg.vocab, prompt_lens=[8, 8, 11],
                                 gen_lens=[2, 7, 4], seed=r)
        stats = ContinuousBatcher(setup, params).run(reqs)
        _assert_pool_is_solo(setup, params, reqs, stats)

    def test_pool_matches_solo_dynamic_calibration(self):
        """Dynamic moment matching: each slot carries its own prompt's
        (B, H) alpha/beta; admission is still grouped (per-row
        calibration), and every row decodes like its solo run."""
        cfg = _tiny_cfg("lln_diag", 2, fixed_ab=False)
        setup = make_pool_setup(cfg, "cpu", slots=2, max_len=32, segment=3)
        params = setup.model.init(3)
        reqs = synthetic_traffic(3, cfg.vocab, prompt_lens=[8],
                                 gen_lens=[3, 6], seed=7)
        eng = ContinuousBatcher(setup, params)
        assert eng.group_admits
        _assert_pool_is_solo(setup, params, reqs, eng.run(reqs))

    @pytest.mark.parametrize("arch,impl", [("mamba2-130m", None),
                                           ("zamba2-7b", "lln_diag")])
    def test_ssm_and_hybrid_pools_match_solo(self, arch, impl):
        """The ssm and hybrid families: SSM states and conv windows per
        row, the shared block's attention state per row."""
        over = {"attn_impl": impl} if impl else {}
        cfg = get_config(arch, smoke=True, compute_dtype="float32", **over)
        setup = make_pool_setup(cfg, "cpu", slots=2, max_len=24, segment=3)
        params = setup.model.init(0)
        reqs = synthetic_traffic(3, cfg.vocab, prompt_lens=[8, 11],
                                 gen_lens=[5, 3], seed=2)
        stats = ContinuousBatcher(setup, params).run(reqs)
        _assert_pool_is_solo(setup, params, reqs, stats)

    def test_pool_matches_the_reference_pool(self):
        """The reference's pool and the port's, from the same weights
        (converted through numpy) and traffic, at lln_diag, r = 4 and
        dynamic calibration: equal tokens for every request."""
        jcfg = _tiny_cfg("lln_diag", 4, cls=JArchConfig)
        tcfg = _tiny_cfg("lln_diag", 4)
        jparams = j_build_model(jcfg).init(jax.random.PRNGKey(0))
        reqs = j_traffic(4, jcfg.vocab, prompt_lens=[8, 8, 11],
                         gen_lens=[3, 7, 5], seed=1)
        mesh = compat_mesh((1, 1), ("data", "model"))
        with mesh:
            jsetup = j_make_pool_setup(jcfg, mesh, slots=2, max_len=32,
                                       segment=3)
            jstats = JBatcher(jsetup, jparams).run(reqs)
        setup = make_pool_setup(tcfg, "cpu", slots=2, max_len=32, segment=3)
        params = params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                          jparams),
                                   setup.cfg, "cpu")
        treqs = synthetic_traffic(4, tcfg.vocab, prompt_lens=[8, 8, 11],
                                  gen_lens=[3, 7, 5], seed=1)
        stats = ContinuousBatcher(setup, params).run(treqs)
        for req in treqs:
            np.testing.assert_array_equal(stats.outputs[req.rid],
                                          jstats.outputs[req.rid],
                                          err_msg=f"rid {req.rid}")
        assert stats.statuses == jstats.statuses


class TestMaskedRows:
    @pytest.mark.parametrize("impl", ["softmax", "lln_diag"])
    def test_masked_rows_do_not_mutate_model_caches(self, impl):
        """``model.decode`` under a row mask leaves every cache leaf of the
        masked row bitwise unchanged, and the active rows equal an
        unmasked decode."""
        cfg = _tiny_cfg(impl, 2)
        setup = make_pool_setup(cfg, "cpu", slots=3, max_len=24, segment=1)
        model, params = setup.model, setup.model.init(1)
        rng = np.random.default_rng(2)
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, (3, 8)))
        _, caches = model.prefill(params, {"inputs": toks}, 24)
        mask = torch.tensor([True, False, True])
        tok = torch.tensor([3, 5, 7])
        pos = torch.full((3,), 8, dtype=torch.int32)
        _, masked = model.decode(params, caches, tok, pos, row_mask=mask)
        _, full = model.decode(params, caches, tok, pos,
                               row_mask=torch.ones(3, dtype=torch.bool))
        before = dict(leaves_with_path(caches))
        after_all = dict(leaves_with_path(full))
        for path, after in leaves_with_path(masked):
            name = path_str(path)
            assert torch.equal(after[1], before[path][1]), \
                f"masked row mutated: {name}"
            assert torch.equal(after[0], after_all[path][0]), \
                f"active row diverged under masking: {name}"

    @pytest.mark.parametrize("impl", ["softmax", "lln_diag"])
    def test_masked_row_logits_never_reach_sampling(self, impl):
        """A free slot poisoned with NaN: the active row's tokens (sampled
        at temperature 0.7 from the same generator state) equal a clean
        pool's, and no NaN-shaped token leaks into the stream."""
        cfg = _tiny_cfg(impl, 2)
        setup = make_pool_setup(cfg, "cpu", slots=2, max_len=32, segment=4,
                                temperature=0.7)
        params = setup.model.init(4)
        prompt = torch.as_tensor(
            np.random.default_rng(5).integers(0, cfg.vocab, (1, 8)))
        _, slot_caches = setup.prefill_fn(params, prompt)

        def run_segment(pool):
            gen = torch.Generator().manual_seed(6)
            out = setup.segment_fn(
                params, pool, torch.tensor([7, 0]),
                torch.tensor([8, 0], dtype=torch.int32),
                torch.tensor([4, 0], dtype=torch.int32),
                torch.tensor([True, False]), gen)
            return out[5].numpy(), out[6].numpy(), out[1].numpy()

        clean = setup.admit_fn(setup.cache_init(), slot_caches, [0])
        toks_c, em_c, tok_c = run_segment(clean)
        poisoned = poison_rows(
            setup.admit_fn(setup.cache_init(), slot_caches, [0]), [1])
        toks_p, em_p, tok_p = run_segment(poisoned)
        np.testing.assert_array_equal(em_c, em_p)
        np.testing.assert_array_equal(toks_c[:, 0], toks_p[:, 0])
        assert tok_c[0] == tok_p[0]
        assert (toks_p[em_p] >= 0).all()


class TestEvictAndAdmit:
    def test_evict_resets_alpha_beta_to_init(self):
        cfg = _tiny_cfg("lln_diag", 2)
        setup = make_pool_setup(cfg, "cpu", slots=2, max_len=32, segment=2)
        params = setup.model.init(7)
        prompt = torch.as_tensor(
            np.random.default_rng(8).integers(0, cfg.vocab, (1, 8)))
        _, sc = setup.prefill_fn(params, prompt)
        pooled = setup.admit_fn(setup.cache_init(), sc, [1])
        alpha = pooled["layers"][0].alpha[1]
        assert not torch.allclose(alpha, torch.ones_like(alpha))
        pooled = setup.evict_fn(pooled, torch.tensor([False, True]))
        for path, leaf in leaves_with_path(pooled):
            want = 1 if path[-1] in ("alpha", "beta") else 0
            assert torch.equal(leaf[1], torch.full_like(leaf[1], want)), \
                f"evict left {path_str(path)} at non-init values"

    def test_engine_evict_takes_indices_and_masks(self):
        eng = AttentionEngine.from_cfg(_tiny_cfg("lln", 2))
        state = eng.init_state(3, "cpu", 16)
        state = state.replace(s=torch.ones_like(state.s),
                              alpha=torch.full_like(state.alpha, 2.0))
        by_idx = eng.evict(state, [2])
        by_mask = eng.evict(state, torch.tensor([False, False, True]))
        for got in (by_idx, by_mask):
            assert torch.equal(got.s[2], torch.zeros_like(got.s[2]))
            assert torch.equal(got.alpha[2], torch.ones_like(got.alpha[2]))
            assert torch.equal(got.s[:2], state.s[:2])
        assert torch.equal(state.s, torch.ones_like(state.s))  # not modified

    def test_readmit_into_evicted_slot_matches_solo(self):
        """One slot: request B runs through the slot request A left, with
        other prompt statistics; stale state would show in its tokens."""
        cfg = _tiny_cfg("lln_diag", 2)
        setup = make_pool_setup(cfg, "cpu", slots=1, max_len=32, segment=2)
        params = setup.model.init(9)
        reqs = synthetic_traffic(2, cfg.vocab, prompt_lens=[8, 11],
                                 gen_lens=[3, 5], seed=11)
        _assert_pool_is_solo(setup, params, reqs,
                             ContinuousBatcher(setup, params).run(reqs))

    def test_admit_writes_exactly_one_row(self):
        cfg = _tiny_cfg("lln_diag", 2, fixed_ab=True)
        setup = make_pool_setup(cfg, "cpu", slots=3, max_len=32, segment=2)
        params = setup.model.init(6)
        pooled = setup.cache_init()
        before = dict(leaves_with_path(pooled))
        _, sc = setup.prefill_fn(params,
                                    torch.ones((1, 8), dtype=torch.long))
        new = setup.admit_fn(pooled, sc, [1])
        slot = dict(leaves_with_path(sc))
        for path, leaf in leaves_with_path(new):
            for row in (0, 2):
                assert torch.equal(leaf[row], before[path][row]), \
                    f"admit leaked into row {row}: {path_str(path)}"
            assert torch.equal(leaf[1], slot[path][0].to(leaf.dtype))
        assert all(int(st.pos[1]) == 8 for st in new["layers"])


# ---------------------------------------------------------------------------
# The robustness layer (the reference's tests/test_robustness.py).
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Pool:
    cfg: object
    params: object
    setup: object


@pytest.fixture(scope="module")
def pool():
    """One shared 2-slot pool with dynamic per-row calibration (the
    hardest recovery mode: alpha/beta must survive a re-prefill
    bitwise)."""
    cfg = _tiny_cfg()
    setup = make_pool_setup(cfg, "cpu", slots=2, max_len=48, segment=3)
    return _Pool(cfg=cfg, params=setup.model.init(0), setup=setup)


def _run(pool, reqs, **kw):
    return ContinuousBatcher(pool.setup, pool.params).run(reqs, **kw)


class TestSentinel:
    def test_row_health_flags_each_failure_mode(self):
        s = torch.zeros(4, 2, 3)
        s[1, 0, 2] = float("nan")
        s[2, 1, 1] = 1e9                      # magnitude explosion
        alpha = torch.ones(4, 2)
        alpha[3, 0] = -0.5                    # calibration drift
        flags = row_health({"s": s, "alpha": alpha,
                            "len": torch.zeros(4, dtype=torch.int32)})
        assert flags["nonfinite"].tolist() == [False, True, False, False]
        assert flags["magnitude"].tolist() == [False, False, True, False]
        assert flags["calib"].tolist() == [False, False, False, True]
        assert flags["unhealthy"].tolist() == [False, True, True, True]

    def test_config_disables_checks(self):
        s = torch.zeros(2, 3)
        s[1] = 1e9
        got = unhealthy_rows({"s": s},
                             config=HealthConfig(check_magnitude=False))
        assert not got.any()

    def test_no_float_leaves_raises(self):
        with pytest.raises(ValueError):
            row_health({"len": torch.zeros(2, dtype=torch.int32)})

    def test_engine_check_health_hook(self):
        spec = AttnSpec(impl="lln_diag", causal=True, r=2, lln_chunk=8,
                        diag_block=8, fixed_ab=2.1)
        eng = AttentionEngine(spec=spec, heads=4, kv_heads=2, head_dim=8,
                              v_dim=8)
        rng = np.random.default_rng(1)
        q, k, v = (torch.as_tensor(rng.normal(size=(2, 16, h, 8)),
                                   dtype=torch.float32) for h in (4, 2, 2))
        _, state = eng.prefill(q, k, v, max_len=24)
        assert not eng.check_health(state)["unhealthy"].any()
        assert eng.check_health(poison_rows(state, [0]))[
            "unhealthy"].tolist() == [True, False]

    def test_free_pool_slot_is_healthy_by_construction(self, pool):
        assert not unhealthy_rows(pool.setup.cache_init()).any()

    def test_poison_rows_hits_only_target_rows(self, pool):
        bad = poison_rows(pool.setup.cache_init(), [1])
        assert unhealthy_rows(bad).tolist() == [False, True]


class TestQuarantineRecovery:
    def test_nan_row_recovers_and_healthy_rows_unaffected(self, pool):
        """Poison slot 0 mid-run: healthy rows equal the fault-free run
        token for token; the quarantined request recovers (re-prefill and
        replay) to the same tokens with status ``retried``."""
        reqs = synthetic_traffic(3, pool.cfg.vocab, prompt_lens=[8, 11],
                                 gen_lens=[14, 9], seed=3)
        clean = _run(pool, reqs)
        assert all(v == "done" for v in clean.statuses.values())
        plan = FaultPlan(events=[FaultEvent(kind="nan", segment=2, row=0)])
        faulty = _run(pool, reqs, fault_plan=plan)
        assert faulty.recoveries == 1
        assert len(faulty.health_events) == 1
        hurt = faulty.health_events[0]["rid"]
        assert hurt >= 0
        for req in reqs:
            np.testing.assert_array_equal(faulty.outputs[req.rid],
                                          clean.outputs[req.rid],
                                          err_msg=f"rid {req.rid}")
            assert faulty.statuses[req.rid] == (
                "retried" if req.rid == hurt else "done")
        assert faulty.completed_tokens == clean.completed_tokens

    def test_poisoned_free_slot_resets_silently(self, pool):
        reqs = synthetic_traffic(1, pool.cfg.vocab, prompt_lens=[8],
                                 gen_lens=[10], seed=5)
        clean = _run(pool, reqs)
        plan = FaultPlan(events=[FaultEvent(kind="nan", segment=1, row=1)])
        faulty = _run(pool, reqs, fault_plan=plan)
        np.testing.assert_array_equal(faulty.outputs[0], clean.outputs[0])
        assert faulty.statuses[0] == "done"
        assert faulty.recoveries == 0
        assert faulty.health_events and faulty.health_events[0]["rid"] == -1

    def test_retry_exhaustion_fails_request(self, pool):
        reqs = synthetic_traffic(1, pool.cfg.vocab, prompt_lens=[8],
                                 gen_lens=[30], seed=9)
        plan = FaultPlan(events=[FaultEvent(kind="nan", segment=s, row=0)
                                 for s in (1, 4, 8)])
        eng = ContinuousBatcher(pool.setup, pool.params, max_retries=2)
        stats = eng.run(reqs, fault_plan=plan)
        assert stats.statuses[0] == "failed"
        assert "retries exhausted" in stats.reject_reasons[0]
        assert stats.failed == 1

    def test_drop_fault_cancels_request(self, pool):
        reqs = synthetic_traffic(2, pool.cfg.vocab, prompt_lens=[8],
                                 gen_lens=[12], seed=11)
        clean = _run(pool, reqs)
        plan = FaultPlan(events=[FaultEvent(kind="drop", segment=1, rid=0)])
        faulty = _run(pool, reqs, fault_plan=plan)
        assert faulty.statuses[0] == "failed"
        assert "dropped" in faulty.reject_reasons[0]
        assert faulty.statuses[1] == "done"
        np.testing.assert_array_equal(faulty.outputs[1], clean.outputs[1])


class TestAdmissionGuards:
    def test_typed_validation_errors(self, pool):
        eng = ContinuousBatcher(pool.setup, pool.params)
        ok = np.zeros((8,), np.int32)
        for req in [
                Request(rid=-2, prompt=ok, gen_len=4),
                Request(rid=1, prompt=np.zeros((0,), np.int32), gen_len=4),
                Request(rid=2, prompt=np.zeros((8,), np.float32), gen_len=4),
                Request(rid=3, prompt=ok + pool.cfg.vocab, gen_len=4),
                Request(rid=4, prompt=ok, gen_len=0),
                Request(rid=5, prompt=ok, gen_len=1000),
                Request(rid=6, prompt=ok, gen_len=4, deadline_s=-1.0),
                Request(rid=7, prompt=ok, gen_len=4, max_tokens=0)]:
            with pytest.raises(AdmissionError):
                eng.check_request(req)

    def test_rejected_requests_get_status_and_survivors_complete(self, pool):
        good = synthetic_traffic(2, pool.cfg.vocab, prompt_lens=[8],
                                 gen_lens=[6], seed=13)
        bad = [Request(rid=10, prompt=np.zeros((8,), np.int32),
                       gen_len=1000),
               Request(rid=11, prompt=np.full((8,), pool.cfg.vocab,
                                              np.int32), gen_len=4)]
        clean = _run(pool, good)
        stats = _run(pool, good + bad)
        assert stats.statuses[10] == "rejected"
        assert "max_len" in stats.reject_reasons[10]
        assert stats.statuses[11] == "rejected"
        assert stats.rejected == 2
        for req in good:
            assert stats.statuses[req.rid] == "done"
            np.testing.assert_array_equal(stats.outputs[req.rid],
                                          clean.outputs[req.rid])

    def test_duplicate_rid_rejected(self, pool):
        reqs = synthetic_traffic(1, pool.cfg.vocab, prompt_lens=[8],
                                 gen_lens=[4], seed=15)
        stats = _run(pool, reqs + [Request(rid=0, prompt=reqs[0].prompt,
                                           gen_len=4)])
        assert stats.statuses[0] == "done"
        assert stats.rejected == 1

    def test_queue_cap_rejects_overflow(self, pool):
        reqs = synthetic_traffic(4, pool.cfg.vocab, prompt_lens=[8],
                                 gen_lens=[4], seed=17)
        stats = ContinuousBatcher(pool.setup, pool.params,
                                  queue_cap=2).run(reqs)
        served = [r for r, v in stats.statuses.items() if v == "done"]
        capped = [r for r, v in stats.statuses.items() if v == "rejected"]
        assert len(served) == 2 and len(capped) == 2
        for rid in capped:
            assert "queue" in stats.reject_reasons[rid]

    def test_max_tokens_bounds_output_buffer(self, pool):
        stats = _run(pool, [Request(rid=0, prompt=np.zeros((8,), np.int32),
                                    gen_len=20, max_tokens=5)])
        assert stats.statuses[0] == "done"
        assert len(stats.outputs[0]) == 5


class TestDeadlines:
    def test_deadline_times_out_with_partial_output(self, pool):
        stats = _run(pool, [
            Request(rid=0, prompt=np.zeros((8,), np.int32), gen_len=30,
                    deadline_s=1e-4),
            Request(rid=1, prompt=np.ones((8,), np.int32), gen_len=6)])
        assert stats.statuses[0] == "timeout"
        assert stats.timeouts == 1
        assert 1 <= len(stats.outputs[0]) < 30
        assert stats.statuses[1] == "done"
        assert len(stats.outputs[1]) == 6

    def test_delay_fault_trips_watchdog(self, pool):
        reqs = synthetic_traffic(1, pool.cfg.vocab, prompt_lens=[8],
                                 gen_lens=[36], seed=21)
        plan = FaultPlan(events=[FaultEvent(kind="delay", segment=8,
                                            seconds=1.0)])
        stats = _run(pool, reqs, fault_plan=plan)
        assert stats.segment_ewma_s > 0
        assert [r for r in stats.stragglers if r.duration >= 1.0], \
            "a 1 s delay must register as a straggler"


class TestKillRestore:
    def test_kill_and_restore_resumes_identically(self, pool, tmp_path):
        """A kill after segment 3 with a snapshot every segment:
        ``run(resume=True)`` finishes every request with the crash-free
        run's tokens."""
        reqs = synthetic_traffic(3, pool.cfg.vocab, prompt_lens=[8, 11],
                                 gen_lens=[16, 9], seed=23)
        clean = _run(pool, reqs)
        mgr = CheckpointManager(str(tmp_path), keep_n=2, interval=1)
        eng = ContinuousBatcher(pool.setup, pool.params, snapshot_mgr=mgr,
                                snapshot_every=1)
        plan = FaultPlan(events=[FaultEvent(kind="kill", segment=3)])
        with pytest.raises(SimulatedCrash):
            eng.run(reqs, fault_plan=plan)
        assert mgr.latest_step() == 3
        stats = eng.run([], resume=True)
        assert stats.restored_step == 3
        assert stats.snapshots > 0
        for req in reqs:
            np.testing.assert_array_equal(stats.outputs[req.rid],
                                          clean.outputs[req.rid],
                                          err_msg=f"rid {req.rid}")
            assert stats.statuses[req.rid] == "done"

    def test_resume_without_snapshot_raises(self, pool, tmp_path):
        mgr = CheckpointManager(str(tmp_path), interval=1)
        eng = ContinuousBatcher(pool.setup, pool.params, snapshot_mgr=mgr,
                                snapshot_every=1)
        with pytest.raises(RuntimeError):
            eng.run([], resume=True)


class TestFaultPlan:
    def test_json_roundtrip_and_inline_load(self):
        plan = FaultPlan(events=[FaultEvent(kind="nan", segment=2, row=1),
                                 FaultEvent(kind="kill", segment=4)], seed=7)
        back = FaultPlan.load(plan.to_json())
        assert back.seed == 7
        assert [e.kind for e in back.events] == ["nan", "kill"]
        assert back.at(4)[0].kind == "kill"

    def test_bad_kind_rejected(self):
        with pytest.raises(ValueError):
            FaultEvent(kind="meteor", segment=0)

    def test_seeded_row_pick_matches_the_reference(self):
        """The same seed picks the same rows in both packages (numpy)."""
        from repro.launch.faults import FaultEvent as JEvent
        from repro.launch.faults import FaultPlan as JPlan
        ev, jev = (cls(kind="nan", segment=0, row=-1)
                   for cls in (FaultEvent, JEvent))
        active = np.array([True, False, True, True, False, True, True,
                           False])
        plan, jplan = FaultPlan(events=[ev], seed=3), JPlan(events=[jev],
                                                            seed=3)
        rows = [plan.pick_row(ev, 8, active) for _ in range(5)]
        assert rows == [jplan.pick_row(jev, 8, active) for _ in range(5)]
        again = FaultPlan(events=[ev], seed=3)
        assert rows == [again.pick_row(ev, 8, active) for _ in range(5)]


class TestUnported:
    def test_speculative_rows_name_item_9(self):
        """Speculative rows (item 9) raised before they were ported; now
        the pool pairs target and draft caches (the ssm family, which has
        no first-k-layers draft, still refuses)."""
        setup = make_pool_setup(_tiny_cfg(), "cpu", slots=2, max_len=32,
                                spec_k=2, draft_layers=1)
        assert setup.spec_k == 2 and setup.draft_layers == 1
        assert setup.draft_model.cfg.n_layers == 1
        caches = setup.cache_init()
        assert set(caches) == {"target", "draft"}
        assert len(caches["target"]["layers"]) == 2
        assert len(caches["draft"]["layers"]) == 1
        with pytest.raises(NotImplementedError, match="first-k-layers"):
            make_pool_setup(get_config("mamba2-130m", smoke=True), "cpu",
                            slots=2, max_len=32, spec_k=2, draft_layers=1)

    def test_moe_names_item_11b(self):
        """Item 11b ported the MoE pool: a MoE config builds its pool (its
        blocks route), while MLA keeps the reference's refusal."""
        cfg = dataclasses.replace(_tiny_cfg(), family="moe", n_experts=4,
                                  expert_d_ff=32)
        setup = make_pool_setup(cfg, "cpu", slots=2, max_len=32)
        assert hasattr(setup.model.init(0).layers[0], "moe")
        with pytest.raises(NotImplementedError,
                           match="continuous batching supports dense/moe"):
            make_pool_setup(dataclasses.replace(cfg, kv_lora=8), "cpu",
                            slots=2, max_len=32)


class TestServeCLI:
    def test_continuous_serves_every_request(self, capsys):
        from repro_torch.launch import serve
        stats = serve.main(["--arch", "yi-9b", "--smoke", "--attn-impl",
                            "lln_diag", "--device", "cpu", "--continuous",
                            "--requests", "8", "--gen-lens", "4,12"])
        assert stats.statuses == {i: "done" for i in range(8)}
        assert [len(stats.outputs[i]) for i in range(8)] == [4, 12] * 4
        assert "continuous: 8 requests over 4 slots" in capsys.readouterr().out

    def test_continuous_kill_and_restore(self, tmp_path, capsys):
        """A kill fault stops the first call; ``--restore`` from the same
        snapshot directory finishes every request, as an uninterrupted
        call does."""
        from repro_torch.launch import serve
        base = ["--arch", "yi-9b", "--smoke", "--attn-impl", "lln",
                "--device", "cpu", "--continuous", "--batch", "2",
                "--segment", "2", "--gen-lens", "4,9"]
        clean = serve.main(base + ["--requests", "4"])
        snap = ["--snapshot-dir", str(tmp_path), "--snapshot-every", "2"]
        plan = '{"events": [{"kind": "kill", "segment": 3}]}'
        assert serve.main(base + ["--requests", "4", "--fault-plan", plan]
                          + snap) is None
        assert "simulated crash" in capsys.readouterr().out
        stats = serve.main(base + ["--requests", "0", "--restore"] + snap)
        assert stats.restored_step == 2
        for rid in range(4):
            np.testing.assert_array_equal(stats.outputs[rid],
                                          clean.outputs[rid])
