"""The MoE family in the port (qwen3-moe-235b-a22b), held against the JAX
reference.

* The config is the reference's copy.
* ``models/moe.py`` on its meshless path: the fp32 router's top-k ids and
  renormalised weights, the Switch aux loss, each slot's rank within its
  expert (a stable sort, ties in the routed ids included) and
  ``moe_apply``'s output (with deepseek-v2's shared expert too) at
  ``capacity_factor = 0.5``, where slots are dropped (checked), and at
  ``n_experts / top_k``, where none can be, from converted weights, within
  1e-5 of the largest entry (fp32).
* qwen3-moe SMOKE (``lln``, ``lln_diag``): ``Model.hidden`` and
  ``Model.loss`` (the summed aux loss included), the prefill logits and 8
  teacher-forced decode steps against the reference's ``build_model``
  (``_torch_families.py``); greedy tokens equal.
* The pool and speculative decoding: a 2-slot pool (``spec_k`` 0 and 2)
  equals solo runs and greedy speculative decoding the plain greedy loop.
  A row's MoE output depends on the other rows of its batch wherever a
  slot is dropped (the capacity is per batch, in the reference as here),
  so these run at ``capacity_factor = n_experts / top_k``, where no slot
  can drop.  The pool refuses MLA, the encoder-decoder and the VLM with
  the reference's words.
* The serve CLI for the arch, alone, ``--continuous`` and
  ``--speculative``.
* Training: qwen3-moe SMOKE (``lln_diag``, ``use_kernel`` False and True)
  from the reference's initial state, the first-step gradient of every
  leaf against ``jax.grad`` and 3 ``make_train_setup`` steps
  (``_torch_families.trains_like_the_reference``), at the reference's
  ``capacity_factor`` of 1.25, where slots drop in the first batch
  (checked): a dropped slot adds nothing to the output, so its expert
  weights get no gradient from it, in the port as in the reference.

Every JAX run is made once per module (module-scoped fixtures).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread per test worker)
import _torch_families as fam

from repro.configs import get_config as j_get_config
from repro.models import moe as jmoe
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import serve
from repro_torch.launch.batcher import ContinuousBatcher, synthetic_traffic
from repro_torch.launch.steps import (flatten_spec_tokens, make_pool_setup,
                                      make_serve_setup, make_spec_setup)
from repro_torch.models import moe

ARCH = "qwen3-moe-235b-a22b"


def test_config_copies_the_reference():
    for smoke in (False, True):
        assert dataclasses.asdict(get_config(ARCH, smoke=smoke)) == \
            dataclasses.asdict(j_get_config(ARCH, smoke=smoke))
    cfg = get_config(ARCH)
    assert (cfg.n_experts, cfg.top_k, cfg.expert_d_ff, cfg.hd) == \
        (128, 8, 1536, 128)


def test_route_and_positions_match_the_reference():
    """Top-k ids and weights, the aux loss, and the slot ranks of a routed
    id list with ties (the stable sort keeps token order)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(24, 16)).astype(np.float32)
    w = rng.normal(size=(16, 8)).astype(np.float32)
    idx, wt, aux = moe._route(torch.from_numpy(x), torch.from_numpy(w), 3)
    jidx, jwt, jaux = jmoe._route(jnp.asarray(x), jnp.asarray(w), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    fam.close(wt, jwt)
    fam.close(aux, jaux)
    flat = rng.integers(0, 5, size=40)
    pos = moe._positions_in_expert(torch.from_numpy(flat), 5)
    np.testing.assert_array_equal(
        pos.numpy(), np.asarray(jmoe._positions_in_expert(jnp.asarray(flat),
                                                          5)))


@pytest.mark.parametrize("capacity_factor", [0.5, 4.0])
def test_moe_apply_matches_the_reference(capacity_factor):
    """``moe_apply`` (no shared experts) and deepseek-v2's variant with a
    shared expert, from the reference's weights; at 0.5 some slots are
    past the capacity and dropped, at n_experts / top_k = 4 none can be."""
    for arch in (ARCH, "deepseek-v2-236b"):
        over = dict(compute_dtype="float32", capacity_factor=capacity_factor)
        cfg = get_config(arch, smoke=True, **over)
        jcfg = j_get_config(arch, smoke=True, **over)
        jp = jmoe.moe_init(jax.random.PRNGKey(3), jcfg)
        p = moe.moe_init(cfg, "cpu")
        with torch.no_grad():
            for name, a in jp.items():
                getattr(p, name).copy_(torch.from_numpy(np.array(a)))
        x = np.random.default_rng(1).normal(
            size=(2, 12, cfg.d_model)).astype(np.float32)
        out, aux = moe.moe_apply(p, torch.from_numpy(x), cfg)
        jout, jaux = jmoe.moe_apply(jp, jnp.asarray(x), jcfg)
        fam.close(out, jout)
        fam.close(aux, jaux)
        idx, _, _ = moe._route(torch.from_numpy(x).reshape(24, -1),
                               p.router_w, cfg.top_k)
        pos = moe._positions_in_expert(idx.reshape(-1), cfg.n_experts)
        cap = max(int(24 * cfg.top_k * capacity_factor / cfg.n_experts), 1)
        dropped = int((pos >= cap).sum())
        assert (dropped > 0) == (capacity_factor < 1.0), dropped


@pytest.fixture(scope="module", params=["lln", "lln_diag"])
def reference(request):
    return request.param, fam.reference_run(ARCH, request.param)


def test_serves_like_the_reference(reference):
    impl, ref = reference
    fam.port_matches(ARCH, impl, ref)


def _no_drop_cfg(impl="lln_diag"):
    cfg = get_config(ARCH, smoke=True, attn_impl=impl,
                     compute_dtype="float32")
    return cfg.replace(capacity_factor=cfg.n_experts / cfg.top_k)


def _solo(cfg, params, req, max_len):
    sv = make_serve_setup(cfg, ShapeSpec("solo", max_len, 1, "decode"),
                          device="cpu")
    logits, caches = sv.prefill_fn(params, {
        "inputs": torch.as_tensor(req.prompt, dtype=torch.long)[None]})
    tok = torch.argmax(logits[:, -1], -1)
    toks, _ = sv.make_generate(req.budget - 1)(params, caches, tok,
                                               len(req.prompt))
    return [int(tok)] + toks[0].tolist()


@pytest.mark.parametrize("spec_k", [0, 2])
def test_pool_matches_solo_runs(spec_k):
    """A 2-slot pool over 4 mixed-length requests, plain (``spec_k`` 0)
    and speculative (``spec_k`` 2, a 1-layer draft): every request's
    tokens equal its solo greedy run."""
    cfg = _no_drop_cfg()
    setup = make_pool_setup(cfg, "cpu", slots=2, max_len=40, segment=3,
                            spec_k=spec_k, draft_layers=1 if spec_k else 0)
    params = setup.model.init(0)
    reqs = synthetic_traffic(4, cfg.vocab, prompt_lens=[8, 8, 11],
                             gen_lens=[3, 7, 5], seed=5)
    stats = ContinuousBatcher(setup, params).run(reqs)
    for req in reqs:
        assert stats.outputs[req.rid].tolist() == _solo(
            setup.cfg, params, req, 40), req.rid


def test_speculative_greedy_matches_the_plain_loop():
    """``make_spec_setup`` (k = 3, a 1-layer draft): greedy speculative
    tokens equal the plain greedy loop's."""
    cfg = _no_drop_cfg("lln")
    plen, steps, k = 9, 10, 3
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, plen)))
    sp = make_spec_setup(cfg, ShapeSpec("s", plen + steps + k + 2, 2,
                                        "decode"), "cpu", spec_k=k,
                         draft_layers=1)
    params = sp.model.init(1)
    logits, tc, dc = sp.prefill_fn(params, {"inputs": toks})
    tok = torch.argmax(logits[:, -1], -1)
    out, n_emit, *_ = sp.make_generate(steps)(params, tc, dc, tok, plen)
    ss = make_serve_setup(cfg, ShapeSpec("s", plen + steps + 2, 2, "decode"),
                          "cpu")
    _, caches = ss.prefill_fn(params, {"inputs": toks})
    want = ss.make_generate(steps)(params, caches, tok, plen)[0]
    np.testing.assert_array_equal(flatten_spec_tokens(out, n_emit, steps),
                                  want.numpy())


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "seamless-m4t-medium",
                                  "paligemma-3b"])
def test_pool_refuses_other_families(arch):
    with pytest.raises(NotImplementedError,
                       match="continuous batching supports dense/moe"):
        make_pool_setup(get_config(arch, smoke=True), "cpu", slots=2,
                        max_len=32)


def test_serve_cli(capsys):
    """The serve CLI for qwen3-moe SMOKE: static, ``--continuous`` and
    ``--speculative``."""
    base = ["--arch", ARCH, "--smoke", "--attn-impl", "lln_diag", "--device",
            "cpu", "--batch", "2", "--prompt-len", "12"]
    assert serve.main(base + ["--gen", "5"]).shape == (2, 5)
    stats = serve.main(base + ["--continuous", "--requests", "3",
                               "--gen-lens", "2,4"])
    assert stats.statuses == {i: "done" for i in range(3)}
    assert serve.main(base + ["--speculative", "--spec-k", "2", "--gen",
                              "6"]).shape == (2, 5)
    assert "speculative: k=2" in capsys.readouterr().out


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["lln_diag-core", "lln_diag-kernel"])
def test_trains_like_the_reference(use_kernel, monkeypatch):
    """The gradient through the router's renormalised top-k weights, the
    capacity drop, the experts and the summed aux loss, then 3 AdamW
    steps; the first batch's forward drops slots."""
    cfg = get_config(ARCH, smoke=True)
    assert cfg.capacity_factor == 1.25
    route, dropped = moe._route, []

    def counted(x, router_w, top_k):
        idx, w, aux = route(x, router_w, top_k)
        e = router_w.shape[1]
        cap = max(int(x.shape[0] * top_k * cfg.capacity_factor / e), 1)
        pos = moe._positions_in_expert(idx.reshape(-1), e)
        dropped.append(int((pos >= cap).sum()))
        return idx, w, aux

    monkeypatch.setattr(moe, "_route", counted)
    fam.trains_like_the_reference(ARCH, "lln_diag", use_kernel)
    # The first n_layers routes are the first-step gradient's forward.
    assert sum(dropped[:cfg.n_layers]) > 0, dropped
