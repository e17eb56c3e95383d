"""Two gloo ranks of the port's four trainers against the 1-process step at
the global batch, and the pose step with hash dropout against JAX's on a
2-device ``data_mesh``, on the CPU.

The module spawns two rank processes once (``tests/torch_ddp_ranks.py``,
which imports torch and the port only), joined through a ``file://`` store
under the test's temporary directory, so parallel test workers cannot meet.
Each rank takes two steps of each case on its rows of the global batch; the
test process takes the same steps alone on the whole batch.  The existing
``tests/test_torch_{train,vq_train,guide_train,avatar_train}.py`` hold that
1-process step to JAX; here the ranks are held to it: every metric of the
first step and every (summed) gradient within 1e-6 of its scale (a
metric's own, the loss's for a term of the avatar's loss, the largest
gradient element of the model for a gradient), the second step's metrics
within 1e-5 (the parameters then differ already, within 2 lr), the
parameters and buffers after two steps within 2 lr of it (a first AdamW step moves a parameter by about lr times its
gradient's sign) and the VQ's codebooks within 1e-5 of their scale, and the
two ranks' parameters and buffers bit-equal.

The slice as a whole is held to JAX once: the diffusion case's first step
(pose on cached audio features, hash dropout 0.1 in the Pallas attention
in interpret mode and in ``HashDropout``, Bernoulli dropout in the keyframe attention,
guidance dropout 0.2) against JAX's step jitted on the 2 of the 8 virtual
CPU devices that ``data_mesh(2)`` takes, the batch sharded over them.  JAX
draws from its keys what the port draws from its generators, so JAX's draws
are answered by the port's: the t and noise, the guidance-dropout and
attention Bernoulli masks, and the seeds of each hash-dropout and attention
site, recorded from the port's 1-process step; JAX's attention takes the
``"hash"`` mask source, the one the port replays.  Bar: the loss and every
gradient within 2e-5 of scale.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ddp_ranks as ranks_mod  # tests/torch_ddp_ranks.py
from audio2photoreal_tpu.core import config as j_config
from audio2photoreal_tpu.diffusion import gaussian as j_gaussian
from audio2photoreal_tpu.diffusion import losses as j_losses
from audio2photoreal_tpu.diffusion.schedules import make_schedule as j_make_schedule
from audio2photoreal_tpu.models import blocks as j_blocks
from audio2photoreal_tpu.models.film_transformer import FiLMDenoiser as JDenoiser
from audio2photoreal_tpu.ops.pallas import flash as j_flash
from audio2photoreal_tpu.parallel.mesh import data_mesh as j_data_mesh
from audio2photoreal_tpu.parallel.sharding import replicated as j_replicated
from audio2photoreal_tpu.parallel.sharding import shard_batch as j_shard_batch
from audio2photoreal_tpu.train.convert import convert_film_denoiser
from audio2photoreal_tpu_torch import convert
from audio2photoreal_tpu_torch.diffusion import tsample
from audio2photoreal_tpu_torch.models import blocks
from audio2photoreal_tpu_torch.parallel import sharding
from torch_threads import one_torch_thread  # noqa: E402,F401  (tests/torch_threads.py)

CASES = ranks_mod.CASES
LR = {"diffusion": ranks_mod.POSE_LR, "vq": ranks_mod.VQ_LR, "guide": ranks_mod.GUIDE_LR,
      "avatar": ranks_mod.AVATAR_LR}
REL = 1e-6
LATER_REL = 1e-5  # the second step's metrics: the f32 train-parity loss bar
HELPER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_ddp_ranks.py")
ROOT = os.path.dirname(os.path.dirname(HELPER))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the 1-process results, [rank 0's, rank 1's]); the ranks run while
    this process takes the 1-process steps."""
    d = tmp_path_factory.mktemp("ddp")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT, os.environ.get("PYTHONPATH", "")]),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, HELPER, str(r), "2", f"file://{d / 'store'}", str(d / f"rank{r}.pt")],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(2)]
    try:
        single = {name: ranks_mod.run_case(name, None) for name in CASES}
        logs = [p.communicate(timeout=600)[0].decode(errors="replace") for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return single, [torch.load(d / f"rank{r}.pt", weights_only=True) for r in range(2)]


def _scaled(got, want, rel, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= rel * scale, f"{what}: {err:.3g} > {rel} of {scale:.3g}"


@pytest.mark.parametrize("case", CASES)
def test_rank_metrics_match_the_single_process_step(runs, case):
    single, ranks = runs
    for step, want in enumerate(single[case]["metrics"]):
        rel = REL if step == 0 else LATER_REL  # after the first update the parameters differ within 2 lr
        for r, res in enumerate(ranks):
            got = res[case]["metrics"][step]
            assert got.keys() == want.keys()
            for k, v in want.items():
                if np.isnan(v):
                    assert np.isnan(got[k]), (case, step, r, k)
                elif k.startswith("loss_") and case == "avatar":  # a term of the loss: the loss's scale
                    assert abs(got[k] - v) <= rel * abs(want["loss"]), (case, step, r, k, got[k], v)
                else:
                    _scaled(got[k], v, rel, f"{case} step {step} rank {r} {k}")


@pytest.mark.parametrize("case", CASES)
def test_rank_gradients_match_the_single_process_step(runs, case):
    single, ranks = runs
    want = single[case]["grads"]
    scale = max(float(g.abs().max()) for g in want.values())
    for r, res in enumerate(ranks):
        got = res[case]["grads"]
        assert got.keys() == want.keys()
        for name, g in want.items():
            err = float((got[name] - g).abs().max())
            assert err <= REL * scale, f"{case} rank {r} {name}: {err:.3g} > {REL} of {scale:.3g}"


@pytest.mark.parametrize("case", CASES)
def test_rank_state_after_two_steps_matches_and_the_ranks_agree_bit_for_bit(runs, case):
    single, ranks = runs
    want, r0, r1 = single[case]["state"], ranks[0][case]["state"], ranks[1][case]["state"]
    assert want.keys() == r0.keys() == r1.keys()
    for name, v in want.items():
        assert torch.equal(r0[name], r1[name]), f"{case} {name}: the ranks differ"
        if "_codebook." in name:  # the EMA codebooks, summed over the ranks' rows
            _scaled(r0[name], v, 1e-5, f"{case} {name}")
        elif v.is_floating_point():
            err = float((r0[name] - v).abs().max())
            assert err <= 2 * LR[case], f"{case} {name}: {err:.3g} > 2 lr"
        else:
            assert torch.equal(r0[name], v), f"{case} {name}"
    if "ts" in single[case]:  # the loss-aware sampler's history: the global t and losses, in order
        assert torch.equal(ranks[0][case]["ts"], ranks[1][case]["ts"])
        _scaled(ranks[0][case]["ts"], single[case]["ts"], REL, "sampler history")
        assert int((single[case]["ts"] != 0).sum()) == 2 * ranks_mod.BATCH[case]


# ------------------------------------------------ the slice against JAX -- #


@pytest.fixture(scope="module")
def port_draws():
    """The draws of the diffusion case's first step, recorded from the
    port's 1-process step: t and its weights, the noise, the guidance and
    attention Bernoulli masks, the hash and attention seeds."""
    rec = {"t": [], "global": [], "flash": [], "hash": []}
    mp = pytest.MonkeyPatch()
    try:
        sample, draw, flash, hdm = (tsample.loss_second_moment_sample, sharding.draw_global,
                                    blocks.flash_attention, blocks.hash_drop_mult)
        mp.setattr(tsample, "loss_second_moment_sample", lambda *a: rec["t"].append(sample(*a)) or rec["t"][-1])
        mp.setattr(sharding, "draw_global", lambda *a, **k: rec["global"].append(draw(*a, **k)) or rec["global"][-1])

        def flash_rec(*a):
            if len(a) > 6 and a[5] > 0:
                rec["flash"].append(a[6])
            return flash(*a)

        mp.setattr(blocks, "flash_attention", flash_rec)
        mp.setattr(blocks, "hash_drop_mult", lambda seed, *a: rec["hash"].append(seed) or hdm(seed, *a))
        ranks_mod.run_case("diffusion", None, steps=1)
    finally:
        mp.undo()
    return rec


def test_pose_step_with_hash_dropout_matches_jax_on_two_devices(runs, port_draws, monkeypatch):
    _, ranks = runs
    got = ranks[0]["diffusion"]
    rec = port_draws
    (t, w), = rec["t"]
    noise, u, *attn_keep = rec["global"]
    p = 0.2
    bern = [~(u[0] >= p).numpy(), ~(u[1] >= p).numpy(), *(k.numpy() > 0 for k in attn_keep)]
    flash_seeds, hash_seeds = list(rec["flash"]), list(rec["hash"])
    assert flash_seeds and hash_seeds and attn_keep  # every kind of site was crossed

    pm = ranks_mod.pose_model()
    jparams = convert_film_denoiser({k: v.clone() for k, v in pm.state_dict().items()}, "pose",
                                    ranks_mod.POSE["num_layers"])
    b = ranks_mod.pose_batch()
    jm = JDenoiser(j_config.DenoiserConfig(**ranks_mod.POSE))
    jsched = j_make_schedule("cosine", 1000)
    flash = j_flash.flash_attention

    def hash_source(*a, **k):  # the model's call; the custom VJP's own calls pass the source positionally
        if len(a) < 10:
            k.setdefault("dropout_mask_impl", "hash")
        return flash(*a, **k)

    monkeypatch.setattr(j_flash, "flash_attention", hash_source)
    monkeypatch.setattr(jax.random, "randint", lambda *a, **k: jnp.asarray([flash_seeds.pop(0)], jnp.int32))
    monkeypatch.setattr(j_blocks, "_key_to_seed", lambda key: jnp.uint32(hash_seeds.pop(0)))
    monkeypatch.setattr(jax.random, "bernoulli", lambda *a, **k: jnp.asarray(bern.pop(0)))

    def loss_fn(params, batch):
        x0, tt = batch["motion"], batch["t"]
        xt = j_gaussian.q_sample(jsched, x0, tt, batch["noise"])
        out = jm.apply(params, xt, tt, None, batch["keyframes"], batch["keyframe_valid"],
                       cond_drop_prob=p, deterministic=False, audio_features=batch["audio_features"],
                       rngs={"cond_drop": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)})
        terms = j_losses.training_losses(jsched, "xstart", out, x0, xt, tt, batch["mask"][..., None])
        return (terms["loss"] * batch["w"]).mean()

    mesh = j_data_mesh(2)
    assert mesh.devices.size == 2
    batch = j_shard_batch(mesh, {"motion": b["motion"], "mask": b["mask"], "audio_features": b["audio_features"],
                                 "keyframes": b["keyframes"], "keyframe_valid": b["keyframe_valid"],
                                 "t": t.numpy().astype(np.int32), "w": w.numpy(), "noise": noise.numpy()})
    j_flash.reset_trace_flops()
    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(jax.device_put(jparams, j_replicated(mesh)), batch)
    assert j_flash.trace_flops() > 0  # the JAX side went through the Pallas kernels
    assert not (flash_seeds or hash_seeds or bern)  # JAX took every draw the port made

    _scaled(got["metrics"][0]["loss"], float(jloss), 2e-5, "loss")
    want = convert.film_denoiser_state_dict_from_jax(jgrads, "pose", ranks_mod.POSE["num_layers"])
    scale = max(float(np.abs(np.asarray(g)).max()) for g in want.values())
    for name, g in got["grads"].items():
        err = float(np.abs(g.numpy() - np.asarray(want[name])).max())
        assert err <= 2e-5 * scale, f"{name}: {err:.3g} > 2e-5 of {scale:.3g}"
