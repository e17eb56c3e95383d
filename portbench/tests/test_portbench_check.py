"""The check at a tiny size on the CPU: the reference agrees with the
program at the reference's precision, the control in a lower precision
fails, and a run whose timed path is broken underneath comes out not
correct."""

from __future__ import annotations

import time

import pytest
import torch

from portbench import control, harness
from portbench.loads import sample, train
from portbench.tests.tinycells import f32, tiny

SEED = 8_589_934_597  # past 32 bits, as a check's seeds are
WORKLOADS = ("face.train", "pose.sample", "face.sample")


def _drive(cell: harness.Cell, seed: int = SEED) -> harness.Run:
    load = train if cell.traffic["kind"] == "train" else sample
    return load.run(cell, seed, 0.0, False, "cpu", time.perf_counter())


def _correct(run: harness.Run) -> bool:
    return all(v <= limit for _, v, limit in run.checks) and bool(run.checks)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_reference_agrees_with_the_program_in_f32(workload):
    run = _drive(f32(tiny(workload)))
    numbers = {name: v for name, v, _ in run.checks}
    # f32 against f32: rounding alone (AdamW's first steps move a leaf by about lr whatever its gradient's size)
    assert numbers and max(numbers.values()) < 1e-4, numbers
    assert run.attempted >= 1 and run.failed == 0


def test_bf16_training_point_passes_its_limits():
    run = _drive(tiny("face.train"))
    assert _correct(run), run.checks


@pytest.mark.parametrize("workload,precision", [("face.train", "fp8"), ("pose.sample", "bf16"),
                                                ("face.sample", "bf16"), ("face.sample", "tf32")])
def test_control_in_a_lower_precision_fails(workload, precision):
    cell = tiny(workload)
    got = control.readings(cell, SEED, "cpu", precision)
    assert any(got[k] > limit for k, limit in cell.limits.items()), got


def test_half_batch_reading_of_the_reference():
    cell = tiny("face.train")
    got = control.readings(cell, SEED, "cpu", fault="half_batch")
    assert any(got[k] > limit for k, limit in cell.limits.items()), got


def test_frozen_train_state_fails(monkeypatch):
    from audio2photoreal_tpu_torch.train.state import TrainState

    monkeypatch.setattr(TrainState, "apply_gradients", lambda self, grad_norm: None)
    assert not _correct(_drive(tiny("face.train")))


def test_half_batch_train_step_fails(monkeypatch):
    from audio2photoreal_tpu_torch.train import loops

    step = loops.diffusion_train_step

    def half(state, schedule, dcfg, batch, *args, **kwargs):
        n = batch["motion"].shape[0] // 2
        return step(state, schedule, dcfg, {k: v[:n] for k, v in batch.items()}, *args, **kwargs)

    monkeypatch.setattr(loops, "diffusion_train_step", half)
    assert not _correct(_drive(tiny("face.train")))


@pytest.mark.parametrize("workload", ("pose.sample", "face.sample"))
def test_frozen_ddim_state_fails(workload, monkeypatch):
    from audio2photoreal_tpu_torch.diffusion import sampling

    def frozen(s, predict, model_fn, x_T, **kwargs):
        x, x0 = x_T, None
        for i in range(s.num_timesteps - 1, -1, -1):
            t, t_model = sampling._step_t(s.to_device(x.device), i, x.shape[0], x.device)
            x0 = model_fn(x, t_model)  # the step's output is dropped: the state stays as it was
        return sampling.SampleResult(sample=x, pred_xstart=x0)

    monkeypatch.setattr(sampling, "ddim_sample_loop", frozen)
    assert not _correct(_drive(tiny(workload)))


@pytest.mark.parametrize("workload", ("pose.sample", "face.sample"))
def test_altered_answer_fails(workload, monkeypatch):
    from audio2photoreal_tpu_torch.models import cfg as cfg_mod

    real = cfg_mod.cfg_model_fn_cached

    def altered(model, cond, scale):
        fn, calls = real(model, cond, scale), [0]

        def out(x, t):
            calls[0] += 1
            y = fn(x, t)
            return y + (t == 0).float()[:, None, None] * 1e-3 * y.abs().max()  # the last step's answer moved

        return out

    monkeypatch.setattr(cfg_mod, "cfg_model_fn_cached", altered)
    assert not _correct(_drive(tiny(workload)))


def test_altered_guide_token_fails(monkeypatch):
    from audio2photoreal_tpu_torch.models import guide as guide_mod

    monkeypatch.setattr(guide_mod, "nucleus_sample", control._least_likely_first_clip(guide_mod.nucleus_sample))
    run = _drive(tiny("pose.sample"))
    assert dict((n, v) for n, v, _ in run.checks)["guide_tokens"] > 0.0 and not _correct(run)


def test_altered_token_reading_of_the_program():
    cell = tiny("pose.sample")
    got = control.readings(cell, SEED, "cpu", fault="altered_token")
    assert set(got) == set(cell.limits) and got["guide_tokens"] > cell.limits["guide_tokens"], got


@pytest.mark.parametrize("workload", WORKLOADS)
def test_program_readings_are_what_a_run_compares(workload):
    cell = tiny(workload)
    got = control.readings(cell, SEED, "cpu", program=True)
    assert set(got) == set(cell.limits) and all(got[k] <= limit for k, limit in cell.limits.items()), got


@pytest.mark.parametrize("workload", WORKLOADS)
def test_same_seed_same_inputs(workload):
    cell = f32(tiny(workload))
    a, b = _drive(cell, 77), _drive(cell, 77)
    assert [c[1] for c in a.checks] == [c[1] for c in b.checks]
    assert torch.equal(sample.call_audio(5, 1, 2, 3, "cpu"), sample.call_audio(5, 1, 2, 3, "cpu"))
