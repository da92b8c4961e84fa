#!/usr/bin/env python3
"""How far apart the first train step's numbers are on the three attention
routes, in bf16 and in fp32 compute, on one CUDA card.

Run from the repository root:

    python3 tools/first_step_gaps.py

paligemma-3b (18 layers, batch 2 x 512: 256 patches + 256 text) and
qwen3-moe-235b-a22b cut to 1 layer (batch 2 x 512), as chip_smoke.py's
train_vlm and train_moe cells build them (lln_diag, use_kernel=True, fp32
params, one microbatch, the seeded init and first batch): the loss, the
gradient's global norm and the q/k/v weights' gradient norm through the
kernels (backend ``kernel``), their plain versions (``plain``) and the
core reference (``ref``), with bf16 and then fp32 compute, and each
route's relative gap to ``plain``.  The gap between ``plain`` and ``ref``,
two correct routes, is the rounding floor a kernel-against-plain gate
has to sit above.
"""
import os
import sys

sys.path.insert(0, os.getcwd())
sys.path.insert(0, os.path.join(os.getcwd(), "src"))
import torch  # noqa: E402
import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.data import torch_placer  # noqa: E402
from repro_torch.launch.steps import make_train_setup  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import global_norm  # noqa: E402

CELLS = (("paligemma-3b", {}, 2, 512),
         ("qwen3-moe-235b-a22b", dict(n_layers=1), 2, 512))


def main():
    if not torch.cuda.is_available():
        sys.exit("first_step_gaps: needs a CUDA card")
    print(cs.phase_device())
    for arch, cut, b, n in CELLS:
        for cdt in ("bfloat16", "float32"):
            cfg = get_config(arch, attn_impl="lln_diag", use_kernel=True,
                             param_dtype="float32", grad_accum=1,
                             compute_dtype=cdt, **cut)
            setup = make_train_setup(cfg, ShapeSpec("gaps", n, b, "train"),
                                     peak_lr=3e-4, total_steps=1000)
            state = setup.init_state(cs.SEED)
            params = dict(state["params"].named_parameters())
            batch = torch_placer("cuda")(next(cs._synthetic_batches(cfg)(
                cfg.vocab, b, n, seed=cs.SEED)))
            res = {}
            for backend in ("kernel", "plain", "ref"):
                model = build_model(cfg.replace(attn_backend=backend))
                loss = model.loss(state["params"], batch)
                grads = dict(zip(params, torch.autograd.grad(
                    loss, list(params.values()))))
                qkv = {k: g for k, g in grads.items()
                       if k.endswith(cs.QKV)}
                res[backend] = (float(loss.detach()),
                                float(global_norm(grads)),
                                float(global_norm(qkv)))
                del grads, qkv, loss
            print(f"{arch} {cdt} (loss, grad norm, q/k/v grad norm): {res}")
            for k in ("kernel", "ref"):
                print(f"  {k} vs plain relative gaps: " + ", ".join(
                    f"{abs(a - c) / abs(c):.3e}"
                    for a, c in zip(res[k], res["plain"])))
            del setup, state, params, batch
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
