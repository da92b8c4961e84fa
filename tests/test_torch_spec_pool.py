"""The port's speculative request pool (``make_pool_setup(spec_k >= 1)``),
on the CPU.

Mirrors the reference's ``TestSpeculativePool`` (``tests/test_batching.py``)
at its tiny config (2 layers, d_model 64, 4 heads of 16, vocab 128, fp32,
fixed alpha/beta):

* every request the pool serves equals the same request served alone by
  ``make_spec_setup`` (greedy, so token for token), with paired target and
  draft caches, staggered admits and per-row accept counts;
* a nan fault quarantines the row, the recovery re-prefills and replays
  both states, and the tokens equal the run without the fault;
* a row's last iteration may commit past its budget: the harvest caps the
  output at the budget (the tied full draft accepts all ``spec_k`` drafts
  per iteration, so every row overshoots);
* ``check_request`` reserves ``spec_k`` positions of cache slack, the
  acceptance counters add up per run and per request, and the
  ``--continuous --speculative`` CLI serves on the CPU.
"""
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread per test worker)

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.launch.batcher import (AdmissionError, ContinuousBatcher,
                                        Request, synthetic_traffic)
from repro_torch.launch.faults import FaultEvent, FaultPlan
from repro_torch.launch.steps import (flatten_spec_tokens, make_pool_setup,
                                      make_spec_setup)
from repro_torch.tree import leaves_with_path, map_with_path

_TINY = dict(family="dense", n_layers=2, d_model=64, n_heads=4, d_ff=128,
             vocab=128, head_dim=16, diag_block=8, lln_chunk=8,
             softmax_chunk=16, compute_dtype="float32",
             param_dtype="float32", remat="none", tie_embeddings=True)
K = 2


def _tiny_cfg(impl="lln_diag", r=2):
    return ArchConfig(name=f"spec-pool-{impl}-r{r}", n_kv_heads=4 // r,
                      attn_impl=impl,
                      lln_fixed_ab=2.1 if impl != "softmax" else 0.0,
                      **_TINY)


def _pool(impl="lln_diag", r=2, draft_layers=1, segment=3, max_len=40,
          **kw):
    setup = make_pool_setup(_tiny_cfg(impl, r), "cpu", slots=2,
                            max_len=max_len, segment=segment, spec_k=K,
                            draft_layers=draft_layers, **kw)
    return setup, setup.model.init(0)


def _solo_spec(setup, params, req):
    """The request alone through ``make_spec_setup`` (the pool's config)."""
    sp = make_spec_setup(setup.cfg, ShapeSpec("solo", setup.max_len, 1,
                                              "decode"), "cpu", spec_k=K,
                         draft_layers=setup.draft_layers)
    prompt = torch.as_tensor(req.prompt, dtype=torch.long)[None]
    logits, tc, dc = sp.prefill_fn(params, {"inputs": prompt})
    tok = torch.argmax(logits[:, -1], -1)
    out = [int(tok)]
    if req.budget > 1:
        steps = req.budget - 1
        toks, n_emit, *_ = sp.make_generate(steps)(params, tc, dc, tok,
                                                   len(req.prompt))
        out += flatten_spec_tokens(toks, n_emit, steps)[0].tolist()
    return np.asarray(out, np.int32)


def _traffic(seed=1):
    return synthetic_traffic(4, 128, prompt_lens=[8, 8, 11],
                             gen_lens=[3, 9, 6], seed=seed)


@pytest.mark.parametrize("impl,r", [("lln_diag", 2), ("lln", 1),
                                    ("log_linear", 4), ("softmax", 2)])
def test_pool_matches_solo_spec(impl, r):
    setup, params = _pool(impl, r)
    reqs = _traffic(seed=r)
    stats = ContinuousBatcher(setup, params).run(reqs)
    assert set(stats.statuses.values()) == {"done"}
    for req in reqs:
        got = stats.outputs[req.rid]
        assert len(got) == req.budget
        np.testing.assert_array_equal(got, _solo_spec(setup, params, req),
                                      err_msg=f"rid {req.rid}")
    assert stats.spec_k == K and stats.verify_iters > 0
    assert stats.drafted_tokens == K * stats.verify_iters
    acc = np.array(list(stats.request_acceptance.values()))
    assert acc[:, 0].sum() == stats.accepted_tokens
    assert acc[:, 1].sum() == stats.drafted_tokens
    assert 0.0 <= stats.acceptance_rate <= 1.0
    assert 1.0 <= stats.goodput_tokens_per_iter <= K + 1


def test_quarantine_recovery_replays_both_states():
    """A nan in a live row at segment 1 poisons both of its states; the
    sentinel (on the target) quarantines it, and the re-prefill plus the
    replay of target and draft give the fault-free run's tokens."""
    setup, params = _pool(segment=2)
    reqs = _traffic(seed=3)
    clean = ContinuousBatcher(setup, params).run(reqs)
    plan = FaultPlan(events=[FaultEvent(kind="nan", segment=1, row=0)])
    faulty = ContinuousBatcher(setup, params).run(_traffic(seed=3),
                                                  fault_plan=plan)
    assert faulty.recoveries == 1 and len(faulty.health_events) == 1
    assert set(faulty.statuses.values()) <= {"done", "retried"}
    for req in reqs:
        np.testing.assert_array_equal(faulty.outputs[req.rid],
                                      clean.outputs[req.rid],
                                      err_msg=f"rid {req.rid}")


@pytest.mark.parametrize("spec_k", [0, K])
def test_replay_rebuilds_the_row_bit_for_bit(spec_k):
    """The recovery's contract (``PoolSetup.replay_fn``): a row's
    admission group re-prefilled and its recorded steps rerun on their own
    inputs (a speculative step's verify chunk, rejected drafts included)
    give the caches the segment left, bit for bit, in another slot too.
    A replay of the committed tokens in other pieces scores other chunks,
    whose stabilization constants and sums round apart."""
    setup = make_pool_setup(_tiny_cfg(), "cpu", slots=2, max_len=40,
                            segment=6, spec_k=spec_k, draft_layers=1)
    params = setup.model.init(0)
    group = torch.as_tensor(np.random.default_rng(7).integers(
        0, 128, (2, 9)))
    logits, slot_caches = setup.prefill_fn(params, group)
    caches = setup.admit_fn(setup.cache_init(), slot_caches, [0, 1])
    tok = torch.argmax(logits[:, -1], -1)
    pos = torch.full((2,), 9, dtype=torch.int32)
    out = setup.segment_fn(params, caches, tok, pos,
                           torch.full((2,), 30, dtype=torch.int32),
                           torch.tensor([True, True]))
    emitted, inputs = out[6].numpy().astype(int), out[9].numpy()
    assert inputs.shape[:2] == emitted.shape
    assert inputs.shape[2] == spec_k + 1

    _, again = setup.prefill_fn(params, group)
    rebuilt = setup.admit_fn(setup.cache_init(),
                             map_with_path(lambda _, a: a[1:], again), [0])
    off = 0
    for step in range(emitted.shape[0]):
        chunk = torch.zeros(2, inputs.shape[2], dtype=torch.long)
        chunk[0] = torch.as_tensor(inputs[step, 1])
        commit = torch.tensor([emitted[step, 1], 0], dtype=torch.int32)
        rebuilt = setup.replay_fn(params, rebuilt, chunk,
                                  torch.tensor([9 + off, 0],
                                               dtype=torch.int32), commit)
        off += int(emitted[step, 1])
    assert off == int(out[2][1]) - 9
    got = dict(leaves_with_path(rebuilt))
    for path, want in leaves_with_path(out[0]):
        assert torch.equal(got[path][0], want[1]), path


def test_budget_expiry_caps_the_multi_token_harvest():
    """The tied full-depth draft accepts every draft, so each iteration
    emits K + 1 tokens and every budget below overshoots: outputs stop at
    the budget and equal the solo runs; the acceptance rate is one."""
    setup, params = _pool(draft_layers=2)
    reqs = [Request(rid=i, prompt=np.arange(3 + i, 11 + i) % 128,
                    gen_len=g) for i, g in enumerate([2, 5, 7])]
    stats = ContinuousBatcher(setup, params).run(reqs)
    for req in reqs:
        assert len(stats.outputs[req.rid]) == req.budget
        np.testing.assert_array_equal(stats.outputs[req.rid],
                                      _solo_spec(setup, params, req))
    assert stats.acceptance_rate == 1.0
    assert stats.goodput_tokens_per_iter == K + 1


def test_check_request_reserves_the_spec_slack():
    setup, params = _pool(max_len=20)
    eng = ContinuousBatcher(setup, params)
    eng.check_request(Request(rid=0, prompt=np.zeros(8, np.int32),
                              gen_len=20 - 8 - K))
    with pytest.raises(AdmissionError, match="spec slack 2"):
        eng.check_request(Request(rid=1, prompt=np.zeros(8, np.int32),
                                  gen_len=20 - 8 - K + 1))


def test_continuous_speculative_cli(capsys):
    from repro_torch.launch import serve
    stats = serve.main(["--arch", "yi-9b", "--smoke", "--attn-impl",
                        "lln_diag", "--device", "cpu", "--continuous",
                        "--speculative", "--spec-k", "2", "--requests", "5",
                        "--segment", "3", "--gen-lens", "3,8",
                        "--prompt-len", "10", "--batch", "2"])
    assert set(stats.statuses.values()) == {"done"}
    assert [len(stats.outputs[i]) for i in range(5)] == [3, 8, 3, 8, 3]
    out = capsys.readouterr().out
    assert "speculative k=2 draft_layers=1" in out
    assert "tokens/verify-iter" in out
