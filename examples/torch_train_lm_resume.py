"""Fault-tolerant LM training on the PyTorch port: train a reduced
starcoder2, kill the process state mid-run, resume from the checkpoint,
and verify the resumed trajectory matches an uninterrupted run
(deterministic pipeline + exact optimizer state restore).

    PYTHONPATH=src python examples/torch_train_lm_resume.py [--device cpu]
"""

import argparse
import functools
import shutil
import tempfile

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import Checkpointer
from repro_torch.configs.starcoder2_3b import SMOKE as CFG
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.dist.cluster import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.common import DEFAULT_POLICY
from repro_torch.train.optim import OptConfig, init_opt
from repro_torch.train.steps import make_train_step

ap = argparse.ArgumentParser()
ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                help="where to train (no fallback)")
dev = resolve_device(ap.parse_args().device)

opt_cfg = OptConfig(peak_lr=1e-3, warmup_steps=3, decay_steps=20)
step_fn = make_train_step(functools.partial(T.lm_loss, cfg=CFG), opt_cfg)
pipe = TokenPipeline(vocab=CFG.vocab, batch=4, seq_len=64, seed=7)


def run(n_steps, params, opt, start=0, ck=None, ck_every=5):
    losses = []
    for step in range(start, n_steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in pipe.batch_at(step).items()}
        params, opt, m = step_fn(params, opt, batch)
        losses.append(float(m["loss"]))
        if ck and (step + 1) % ck_every == 0:
            ck.save(step + 1, {"params": params, "opt": opt}, blocking=True)
    return params, opt, losses


params0 = T.init_lm(0, CFG, DEFAULT_POLICY, device=dev)
opt0 = init_opt(params0, opt_cfg)

# uninterrupted 12-step reference run
_, _, ref_losses = run(12, params0, opt0)
print("reference  losses:", [round(x, 4) for x in ref_losses])

# interrupted run: 12 steps requested, "crash" after step 10's checkpoint
tmp = tempfile.mkdtemp()
ck = Checkpointer(tmp)
params1, opt1, part_losses = run(10, params0, opt0, ck=ck, ck_every=5)
print(f"crashed at step 10 (checkpointed at {ck.list_steps()})")

# resume: restore latest checkpoint onto the device, continue to 12
start, state = ck.restore(device=dev)
params2, opt2 = state["params"], state["opt"]
_, _, tail_losses = run(12, params2, opt2, start=start)
resumed = part_losses + tail_losses
print("resumed    losses:", [round(x, 4) for x in resumed])

np.testing.assert_allclose(resumed, ref_losses, rtol=1e-5)
print("resumed trajectory == uninterrupted trajectory ✓")
if not ref_losses[-1] < ref_losses[0]:
    raise SystemExit(f"loss should decrease: {ref_losses}")
shutil.rmtree(tmp)
print(f"fault-tolerant training example on {dev} OK")
