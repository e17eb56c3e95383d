"""Traffic of kind ``train``: the body of ``apps/train_diffusion.py:train``'s
loop, step after step, on a synthetic person.

Set-up builds one train state (the model with the weights made from the
seed, AdamW), writes the person under ``TMPDIR``, builds the frozen
frontends' feature cache over its train split with the program's
``build_cache_for_index``, and starts the loader (``make_train_iterator``,
a worker thread assembling pinned batches).  Then ``checked_steps`` steps
run through the window's own call and feed; they warm every shape up and
the check compares them with the reference.  The window runs the same call
until ``seconds`` have passed.  Each step's draws come from generators
seeded by (seed, step) as ``train()`` seeds them.

The check: the reference (``reference/steps.py:train_steps``, f32) takes
the same weights and works out again the batches, their features and the
steps.  Compared: each checked step's loss, the first step's gradient by
leaf (the program's from its AdamW state after that step), and the
parameters' change by leaf after the checked steps, leaving out the leaves
whose reference gradient is under a thousandth of the median leaf's.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from portbench import harness, inputs
from portbench.reference.steps import leaf_norms
from portbench.counters import film as film_count


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool, device: str, t0: float) -> harness.Run:
    from audio2photoreal_tpu_torch.apps.generate import find_stats
    from audio2photoreal_tpu_torch.core.config import DataConfig, DenoiserConfig, DiffusionConfig, TrainConfig
    from audio2photoreal_tpu_torch.data.feature_cache import build_cache_for_index, make_frontend_apply, make_lip_apply
    from audio2photoreal_tpu_torch.data.loader import SceneIndex, make_train_iterator, step_seed
    from audio2photoreal_tpu_torch.diffusion.schedules import make_schedule
    from audio2photoreal_tpu_torch.models.film_transformer import FiLMDenoiser
    from audio2photoreal_tpu_torch.train.loops import diffusion_train_step
    from audio2photoreal_tpu_torch.train.state import TrainState

    tr, cfg = cell.traffic, cell.config
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    mcfg = DenoiserConfig(**{**cfg["denoiser"], **tr["point"]["denoiser"]})
    dcfg = DiffusionConfig(**cfg["diffusion"])
    B, T, pc = tr["batch"], tr["frames"], tr["person"]
    datacfg = DataConfig(person="SYNTH01", data_format=mcfg.data_format, batch_size=B, max_seq_length=T,
                         min_seq_length=tr["min_frames"], num_val_seqs=pc["held_out_scenes"] - 4, num_test_seqs=4)
    tcfg = TrainConfig(lr=tr["lr"], seed=inputs.sub_seed(seed, 2) % 2**31)

    work = tempfile.mkdtemp(prefix="portbench-")
    try:
        root = os.path.join(work, "data")
        inputs.write_person(root, seed, pc["train_scenes"], pc["held_out_scenes"], pc["frames_per_scene"])
        with torch.device(dev):
            model = FiLMDenoiser(mcfg)
        inputs.load_weights(model, inputs.sub_seed(seed, 3), dev)
        model.train()
        sched = make_schedule(dcfg.schedule, dcfg.steps).to_device(dev)
        state = TrainState(model, tcfg)
        start = {n: p.detach().clone() for n, p in model.named_parameters() if p.requires_grad}
        stats = find_stats(os.path.join(root, datacfg.person))
        index = SceneIndex(root, datacfg.person, "train", datacfg.num_val_seqs, datacfg.num_test_seqs)
        lip_apply = make_lip_apply(model.lip_model) if mcfg.data_format == "face" else None
        cache = build_cache_for_index(index, stats.norm_audio, make_frontend_apply(model.audio_model), lip_apply,
                                      verbose=False)

        def to_tensors(b):
            out = {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
            return {k: v.pin_memory() for k, v in out.items()} if cuda else out

        batches, _ = make_train_iterator(root, stats, datacfg, seed=tcfg.seed, feature_cache=cache,
                                         reader=tr["reader"], transform=to_tensors)
        spans = harness.Spans(trace, sync)
        waits, copies, steps_s, losses, bad = [], [], [], [], 0
        i = 0

        def step():
            nonlocal i, bad
            t_start = time.perf_counter()
            with spans("loader", sync=False):
                host = next(batches)
                if cuda:
                    copy = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                    copy[0].record()
                batch = {k: v.to(dev, non_blocking=True) for k, v in host.items()}
                wait = time.perf_counter() - t_start
                if cuda:
                    copy[1].record()
            s = step_seed(tcfg.seed, i)
            with spans("train_step", sync=False):
                metrics, _ = diffusion_train_step(state, sched, dcfg, batch, torch.Generator().manual_seed(s),
                                                  torch.Generator(device=dev).manual_seed(s))
            # the step ends in a read-back, so the copy's events have completed
            copies.append(copy[0].elapsed_time(copy[1]) / 1e3 if cuda else 0.0)
            waits.append(wait + copies[-1])
            steps_s.append(time.perf_counter() - t_start)
            losses.append(metrics["loss"])
            bad += int(metrics["skipped_nonfinite"] > 0 or not np.isfinite(metrics["loss"]))
            i += 1

        n_check = tr["checked_steps"]
        grads = None
        for k in range(n_check):
            step()
            if k == 0:  # the first gradient, from AdamW's first moment: m1 = (1 - b1) g
                b1 = state.optimizer.param_groups[0]["betas"][0]
                grads = leaf_norms((n, state.optimizer.state[p]["exp_avg"] / (1.0 - b1) if p in state.optimizer.state
                                    else torch.zeros_like(p)) for n, p in model.named_parameters() if p.requires_grad)
        sync()
        change = leaf_norms((n, p.detach() - start[n]) for n, p in model.named_parameters() if p.requires_grad)
        checked_losses = list(losses)
        del start
        setup_s = time.perf_counter() - t0

        waits.clear(), copies.clear(), steps_s.clear()
        n0 = i
        with harness.profiled(trace) as prof:
            w0 = time.perf_counter()
            with spans("window", sync=False):
                while True:
                    step()
                    if time.perf_counter() - w0 >= seconds:
                        break
            wall = time.perf_counter() - w0
        n = i - n0
        batches.close()
        q = lambda xs: " ".join(f"{1e3 * v:.1f}" for v in np.quantile(xs, [0.25, 0.5, 0.75, 1.0]))  # noqa: E731
        print(f"window: {n} steps in {wall:.3f} s; step ms (q1 median q3 max) {q(steps_s)}; wait for the batch "
              f"{q([w - c for w, c in zip(waits, copies)])}; copy {q(copies)}; wait share "
              f"{sum(waits) / sum(steps_s):.4f}", file=sys.stderr)
        summary = harness.reduce_trace(prof, spans.ranges) if prof is not None else None
        peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        del state, model, batches, cache
        if cuda:
            torch.cuda.empty_cache()

        shapes = film_count.face_train_shapes(mcfg, B, T)
        out = harness.Run(seconds=wall, setup_s=setup_s, attempted=n, failed=bad, dtype=mcfg.dtype, trace=summary)
        out.work = {"steps": n, "samples": n * B, "batch_wait_s": sum(waits), "step_s": sum(steps_s)}
        out.flops = {"train_step": n * film_count.train_step_flops(mcfg, B, T)}
        out.attention = [(kind, shape, n * count) for kind, shape, count in shapes]
        out.device = {"memory_peak_bytes": int(peak)}
        out.checks = check(cell, root, seed, tcfg.seed, checked_losses, grads, change, dev)
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)


def reference_steps(cell: harness.Cell, root: str, seed: int, run_seed: int, dev, precision=None,
                    drop_half=False) -> dict:
    """The reference's checked steps from the weights of ``seed``."""
    from portbench.reference import steps as ref
    from portbench.reference.config import DenoiserConfig
    from portbench.reference.data import Person

    tr = cell.traffic
    section = {**cell.config["denoiser"], **tr["point"]["denoiser"], "dtype": "float32", "frontend_dtype": "float32"}
    model = ref.build(ref.FiLMDenoiser, DenoiserConfig(**section),
                      lambda m: inputs.make_weights(m, inputs.sub_seed(seed, 3), dev), dev)
    person = Person(os.path.join(root, "SYNTH01"), tr["person"]["held_out_scenes"] - 4, 4)
    model.eval()
    person.compute_features(model.audio_model, model.lip_model, dev)
    return ref.train_steps(model, person, seed=run_seed, steps=tr["checked_steps"], batch=tr["batch"],
                           min_len=tr["min_frames"], max_len=tr["frames"], lr=tr["lr"],
                           cond_drop_prob=cell.config["diffusion"].get("cond_drop_prob", 0.2), device=dev,
                           block_rows=tr["reference_block_rows"], precision=precision, drop_half=drop_half)


def numbers(got_loss, got_grad, got_change, want: dict) -> dict:
    """The compared numbers of a training check."""
    from portbench.reference.steps import leaf_gap

    med = float(np.median(list(want["grad"].values())))
    still = {n for n, g in want["grad"].items() if g < 1e-3 * med}
    return {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(got_loss, want["loss"])),
        "grad_gap": leaf_gap(got_grad, want["grad"]),
        "change_gap": leaf_gap(got_change, want["change"], skip=still),
    }


def check(cell, root, seed, run_seed, losses, grads, change, dev):
    want = reference_steps(cell, root, seed, run_seed, dev)
    got = numbers(losses, grads, change, want)
    return [(k, got[k], limit) for k, limit in cell.limits.items()]
