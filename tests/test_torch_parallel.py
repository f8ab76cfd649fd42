"""The distributed layer (toybox_tpu_torch/parallel) on the CPU: the
cases of tests/test_parallel.py over two spawned gloo ranks, each held
to the single-process port on the same global env set (which the port's
other tests hold to JAX's), plus DQN's ring sharded on its capacity
axis, ACKTR's all-reduced K-FAC factors and ``ppo.learn(mesh=)``.

The ranks are spawned once for the module (``run_ranks``: tiny shapes,
8 envs in all, nsteps 4, a join of at most 120 s), and every phase runs
in that one spawn."""

import numpy as np
import pytest
import torch

from tests.test_torch_codecs import one_torch_thread  # noqa: F401
from toybox_tpu_torch.parallel import mesh as pm
from toybox_tpu_torch.parallel.dryrun import PARAM_TOL, PHASES, run_ranks

OPTS = dict(game="breakout", envs=8, steps=128)
NAMES = ("env", "train", "learn", "dqn", "acktr", "moments")


@pytest.fixture(scope="module")
def two_ranks():
    return run_ranks(NAMES, world=2, device="cpu", timeout=120, **OPTS)


@pytest.fixture(scope="module")
def single():
    torch.set_num_threads(1)
    return {name: PHASES[name](None, "cpu", OPTS) for name in NAMES}


def _close(ranks, single, phase, prefix, rtol, atol):
    """Every rank's ``prefix`` entries within (rtol, atol) of the single
    process's, and equal between the ranks (they are replicated)."""
    keys = [k for k in single[phase] if k.startswith(prefix)]
    assert keys
    for k in keys:
        for r in ranks:
            np.testing.assert_allclose(r[phase][k].numpy(),
                                       single[phase][k].numpy(), rtol=rtol,
                                       atol=atol, err_msg=k)
        torch.testing.assert_close(ranks[0][phase][k], ranks[1][phase][k],
                                   rtol=0, atol=0, equal_nan=True, msg=k)


def test_mesh_shape(two_ranks):
    assert pm.make_mesh().shape == {"env": 1}       # no process group
    assert pm.make_mesh(("env", "model")).shape == {"env": 1, "model": 1}
    with pytest.raises(ValueError, match="process group"):
        pm.make_mesh(devices=[0, 1])
    assert [r["mesh"]["shape"] for r in two_ranks] == [{"env": 2}] * 2
    assert [r["mesh"]["rank"] for r in two_ranks] == [0, 1]


def test_sharded_env_step_matches_unsharded(two_ranks, single):
    """128 steps of 8 one-life Breakout envs, 4 on each rank, past every
    env's game over and the auto-reset's reseeded restart: every state
    field, the last rewards and dones bit-equal to one process's rows,
    and the all-reduced sums (rewards, scores, game overs) equal its
    sums."""
    s = single["env"]
    assert s["global_sums"][2] >= 8            # every env lost its game
    keys = [k for k in s if k.startswith("state.")] + ["reward", "done"]
    assert len(keys) > 10
    for k in keys:
        got = torch.cat([r["env"][k] for r in two_ranks])
        assert torch.equal(got, s[k]), k
    for r in two_ranks:
        assert torch.equal(r["env"]["global_sums"], s["global_sums"])


def test_ppo_update_parity_across_shardings(two_ranks, single):
    """One PPO update (2 epochs of 2 minibatches) over 2 ranks: the
    params and metrics within rtol 2e-4, atol 1e-6 of one process's."""
    rtol, atol = PARAM_TOL
    _close(two_ranks, single, "train", "params.", rtol, atol)
    _close(two_ranks, single, "train", "metrics.", rtol, atol)
    # ppo.learn(mesh=) builds each rank's block of the envs itself
    _close(two_ranks, single, "learn", "params.", rtol, atol)


def test_mesh_moments(two_ranks, single):
    x = np.arange(8.0)
    for m in [r["moments"]["moments"] for r in two_ranks] + [
            single["moments"]["moments"]]:
        mean, std, n = m.numpy()
        assert n == 8
        np.testing.assert_allclose(mean, x.mean(), rtol=1e-6)
        np.testing.assert_allclose(std, x.std(), rtol=1e-6)


def test_process_seed_offset(two_ranks):
    assert pm.process_seed_offset(100, 64) == 100     # single process
    assert [r["mesh"]["seed_offset"] for r in two_ranks] == [100, 164]


def test_dqn_sharded_ring_samples_the_single_rings_slots(two_ranks,
                                                         single):
    """The ring of 16 slots sharded 8 a rank: two cycles' samples, and a
    fresh draw's slots, equal the single ring's; the params within
    1e-6."""
    for r in two_ranks:
        assert torch.equal(r["dqn"]["idx"], single["dqn"]["idx"])
        np.testing.assert_allclose(r["dqn"]["weights"].numpy(),
                                   single["dqn"]["weights"].numpy(),
                                   rtol=1e-6, atol=1e-7)
    _close(two_ranks, single, "dqn", "metrics", 1e-5, 1e-7)
    _close(two_ranks, single, "dqn", "params.", 0, 1e-6)


def test_acktr_factors_are_all_reduced(two_ranks, single):
    """Each K-FAC factor after one update over 2 ranks within 1e-6 of its
    largest entry of one process's; the params within 1e-6."""
    keys = [k for k in single["acktr"] if k.startswith("factors.")]
    assert len(keys) == 12
    for k in keys:
        want = single["acktr"][k]
        scale = float(want.abs().max())
        for r in two_ranks:
            assert float((r["acktr"][k] - want).abs().max()) <= 1e-6 * scale
    _close(two_ranks, single, "acktr", "params.", 0, 1e-6)


@pytest.mark.parametrize("alg", ["ppo", "dqn", "acktr"])
def test_dryrun_on_a_one_rank_mesh_equals_no_mesh(alg):
    """Each learner's dryrun through its sharded path on a mesh of one
    rank (every collective the identity) and without a mesh."""
    import importlib
    mod = importlib.import_module(f"toybox_tpu_torch.rl.{alg}")
    (s0, m0), (s1, m1) = (mod.dryrun(1, "breakout", device="cpu",
                                     sharded=s) for s in (False, True))
    for k, v in s0.module.state_dict().items():
        torch.testing.assert_close(s1.module.state_dict()[k], v, rtol=0,
                                   atol=1e-7)
    for k in m0:
        torch.testing.assert_close(m1[k], m0[k], rtol=1e-6, atol=1e-7,
                                   equal_nan=True)


def test_shard_batch_replicate_and_shardings():
    mesh = pm.make_mesh()
    tree = {"a": torch.arange(6), "b": [torch.ones(2, 3)], "c": 5}
    out = pm.shard_batch(tree, mesh)
    assert torch.equal(out["a"], tree["a"]) and out["c"] == 5
    assert pm.replicate(tree, mesh) is tree
    assert pm.env_sharding(mesh).spec == ("env",)
    assert pm.replicated(mesh).spec == ()
    blk = pm.env_block(None, 4)
    assert (blk.lo, blk.n_local, blk.n_global) == (0, 4, 4)
    two = [pm.Block(mesh, lo, 4, 8) for lo in (0, 4)]    # a ring of 8
    assert [b.runs(6, 5) for b in two] == [[(2, 5, 0)], [(0, 2, 2)]]
    assert blk.runs(3, 3) == [(0, 1, 3), (1, 3, 0)]         # wraps
    dst = torch.zeros(4)
    two[1].scatter(dst, torch.tensor([5, 1, 7, 5]),
                   torch.tensor([1.0, 2.0, 3.0, 1.0]))
    assert dst.tolist() == [0.0, 1.0, 0.0, 3.0]
    with pytest.raises(ValueError, match="no axis"):
        pm.shard_batch(tree, mesh, axis="model")
    assert pm.backend_for("cpu") == "gloo" and pm.backend_for("cuda") == \
        "nccl"
    pm.initialize_distributed(num_processes=1)     # a no-op at one process
    assert not torch.distributed.is_initialized()
