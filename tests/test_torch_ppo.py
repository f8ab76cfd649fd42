"""The port's PPO (toybox_tpu_torch.rl.ppo) against the JAX package's.

- GAE on the same values, rewards, dones and last value: within 1e-6.
- One full update on identical inputs: the JAX ``train_step`` from
  ``init_fn(0)`` on Breakout (2 envs, nsteps 8, 2 minibatches, 2 epochs;
  each minibatch's gradient whole, and accumulated over 2 microbatches)
  against the port's GAE and update fed the JAX rollout (obs, actions,
  values, neglogps, rewards, dones), the JAX epoch permutations and the
  JAX initial params. Tolerance: params within 1e-6 absolute (0.4 % of
  one Adam step at lr 2.5e-4; measured 2.2e-8 on this update), metrics
  within 1e-5 relative or 1e-7 absolute (the policy loss is a mean of
  unit-scale terms that cancel to about 1e-4, so its rounding noise is
  absolute: 1.1e-8 measured). The two frameworks sum the convolutions and
  their gradients in other orders.
- Microbatched gradients equal the one-shot minibatch's.
- The policy saved by the port loads in JAX ``load_params`` and back.
- The identity task is learned (mean reward > 0.8).
- ``run.main`` plumbing, the logger and the checkpointer.
"""

import csv
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from toybox_tpu.envs.pipeline import make_rl_env as j_make_rl_env
from toybox_tpu.rl import ppo as jppo
from toybox_tpu.rl.test_envs import make_discrete_identity_env as j_identity
from toybox_tpu_torch import run
from toybox_tpu_torch.envs.pipeline import make_rl_env as t_make_rl_env
from toybox_tpu_torch.rl import ppo
from toybox_tpu_torch.rl.checkpoint import params_from_flax
from toybox_tpu_torch.rl.distributions import (CategoricalPd, gumbel_max,
                                               make_pdtype)
from toybox_tpu_torch.rl.policies import build_policy
from toybox_tpu_torch.rl.test_envs import make_discrete_identity_env
from toybox_tpu_torch.utils import logger
from toybox_tpu_torch.utils.checkpoint import Checkpointer, latest_checkpoint

NSTEPS, NENVS, NMB, NEPOCHS = 8, 2, 2, 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The torch ops here are small: one intra-op thread does them as fast
    and leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _closure(fn, name):
    """A function that ``fn`` closes over, by name (the JAX make_ppo keeps
    its rollout and GAE inside train_step's closure)."""
    for var, cell in zip(fn.__code__.co_freevars, fn.__closure__):
        if var == name:
            return cell.cell_contents
    raise KeyError(name)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_breakout(microbatches: int) -> dict:
    """The JAX make_ppo on Breakout, its initial state, one train_step
    from it, and the same update's inputs replayed outside train_step with
    its key schedule."""
    env = j_make_rl_env("breakout", NENVS)
    init_fn, train_step, _ = jppo.make_ppo(
        env, network="cnn", nsteps=NSTEPS, nminibatches=NMB,
        noptepochs=NEPOCHS, microbatches=microbatches)
    state0 = init_fn(0)
    rollout = _closure(train_step, "_rollout")
    jgae = _closure(train_step, "_gae")
    p_value = _closure(train_step, "p_value")

    @jax.jit
    def replay(state):
        env_state, key, traj = rollout(state.params, state.env_state,
                                       state.key)
        obs, actions, values, neglogps, rewards, dones = traj[:6]
        last_value = p_value(state.params, env_state.frames)
        advs = jgae(values, rewards, dones, last_value)
        key, *ekeys = jax.random.split(key, NEPOCHS + 1)
        perms = jnp.stack([jax.random.permutation(k, NSTEPS * NENVS)
                           for k in ekeys])
        return dict(obs=obs, actions=actions, values=values,
                    neglogps=neglogps, rewards=rewards, dones=dones,
                    last_value=last_value, advs=advs, perms=perms)

    inputs = _np_tree(replay(state0))
    state1, metrics = jax.jit(train_step)(state0)
    return dict(env=env, state0=state0, state1=state1, inputs=inputs,
                metrics=_np_tree(metrics), gae=jgae,
                microbatches=microbatches)


@pytest.fixture(scope="module")
def jax_breakout():
    return _jax_breakout(1)


@pytest.fixture(scope="module", params=[1, 2])
def jax_update(request, jax_breakout):
    """``jax_breakout`` at ``microbatches`` 1 and 2 (the JAX update that
    normalises each minibatch's advantages, then accumulates the
    gradients of its equal chunks)."""
    return jax_breakout if request.param == 1 else _jax_breakout(
        request.param)


def test_gae_matches_jax(jax_breakout):
    r = np.random.default_rng(0)
    shape = (16, 5)
    values = r.normal(size=shape).astype(np.float32)
    rewards = r.choice([0.0, 1.0, -1.0], size=shape).astype(np.float32)
    dones = r.random(shape) < 0.15
    last = r.normal(size=shape[1]).astype(np.float32)
    want = np.asarray(jax_breakout["gae"](values, rewards, dones, last))
    got = ppo.gae(*map(torch.as_tensor, (values, rewards, dones, last)),
                  0.99, 0.95)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # the rollout's own GAE too
    x = jax_breakout["inputs"]
    got = ppo.gae(*(torch.tensor(x[k]) for k in
                    ("values", "rewards", "dones", "last_value")), 0.99, 0.95)
    np.testing.assert_allclose(got.numpy(), x["advs"], rtol=0, atol=1e-6)


def test_one_update_matches_jax_train_step(jax_update):
    jax_breakout = jax_update
    x = jax_breakout["inputs"]
    assert float(np.abs(x["rewards"]).sum()) > 0     # a reward to learn from
    tenv = t_make_rl_env("breakout", NENVS, device="cpu")
    module, _, _, _ = build_policy(tenv.obs_shape, tenv.num_actions, "cnn",
                                   device="cpu")
    module.load_state_dict(params_from_flax(
        _np_tree(jax_breakout["state0"].params)))
    adam = ppo.AdamState.zeros_like(list(module.parameters()))
    t = {k: torch.tensor(v) for k, v in x.items()}
    advs = ppo.gae(t["values"], t["rewards"], t["dones"], t["last_value"],
                   0.99, 0.95)
    returns = advs + t["values"]
    nbatch = NSTEPS * NENVS
    batch = tuple(v.reshape((nbatch,) + tuple(v.shape[2:])) for v in (
        t["obs"], t["actions"].long(), t["values"], t["neglogps"], returns,
        advs))
    lrnow, cliprnow = ppo.anneal(0, 1, 2.5e-4, 0.1)
    metrics = ppo.update(module, adam, batch, list(t["perms"].long()),
                         lrnow, cliprnow, ppo.Hyper(
                             nminibatches=NMB,
                             microbatches=jax_breakout["microbatches"]),
                         tenv.num_actions)
    want = params_from_flax(_np_tree(jax_breakout["state1"].params))
    before = params_from_flax(_np_tree(jax_breakout["state0"].params))
    got = module.state_dict()
    moved = max(float((want[k] - before[k]).abs().max()) for k in want)
    worst = max(float((got[k] - want[k]).abs().max()) for k in want)
    print(f"params moved up to {moved:.3g}; port vs JAX max diff "
          f"{worst:.3g}")
    assert moved > 1e-4
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)
    for k in ppo.METRICS:
        np.testing.assert_allclose(float(metrics[k]),
                                   float(jax_breakout["metrics"][k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)


def test_save_params_loads_in_jax_and_back(jax_breakout, tmp_path):
    params = jax_breakout["state1"].params
    tenv = t_make_rl_env("breakout", NENVS, device="cpu")
    module, init_fn, _, _ = build_policy(tenv.obs_shape, tenv.num_actions,
                                         "cnn", device="cpu")
    # JAX -> port
    jpath = str(tmp_path / "jax.model")
    jppo.save_params(jpath, params)
    ppo.load_params(jpath, module)
    want = params_from_flax(_np_tree(params))
    for k, v in module.state_dict().items():
        assert torch.equal(v, want[k]), k
    # port -> JAX, into a make_ppo template (the port's own init)
    init_fn(7)
    tpath = str(tmp_path / "port.model")
    ppo.save_params(tpath, module)
    loaded = jppo.load_params(tpath, jax_breakout["state0"].params)
    back = params_from_flax(_np_tree(loaded))
    for k, v in module.state_dict().items():
        assert torch.equal(back[k], v), k
    # the bytes are those the JAX save_params writes for these params
    jpath2 = str(tmp_path / "jax2.model")
    jppo.save_params(jpath2, loaded)
    with open(tpath, "rb") as f, open(jpath2, "rb") as g:
        assert f.read() == g.read()


def test_mlp_params_round_trip_through_jax(tmp_path):
    jenv = j_identity(4, dim=4)
    init_fn, _, _ = jppo.make_ppo(jenv, network="mlp", nsteps=4,
                                  nminibatches=1, noptepochs=1,
                                  network_kwargs=dict(num_hidden=32))
    template = init_fn(0).params
    module, p_init, _, _ = build_policy((4,), 4, "mlp", device="cpu",
                                        num_hidden=32)
    p_init(3)
    path = str(tmp_path / "mlp.model")
    ppo.save_params(path, module)
    loaded = _np_tree(jppo.load_params(path, template))
    assert jax.tree_util.tree_structure(loaded) == \
        jax.tree_util.tree_structure(_np_tree(template))
    back = params_from_flax(loaded)
    for k, v in module.state_dict().items():
        assert torch.equal(back[k], v), k
    # the same obs give the same logits and values on both sides
    obs = np.eye(4, dtype=np.float32)
    jl, jv = jax.jit(_closure_module(jenv, 32).apply)(loaded, obs)
    with torch.no_grad():
        tl, tv = module(torch.as_tensor(obs))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6)


def _closure_module(jenv, hidden):
    from toybox_tpu.rl.policies import build_policy as j_build_policy
    module, _, _, _ = j_build_policy(jenv.obs_shape, jenv.num_actions, "mlp",
                                     num_hidden=hidden)
    return module


def _breakout_ppo(microbatches):
    env = t_make_rl_env("breakout", NENVS, device="cpu")
    init_fn, train_step, _ = ppo.make_ppo(
        env, network="cnn", nsteps=4, nminibatches=2, noptepochs=2,
        total_updates=10, microbatches=microbatches, device="cpu")
    state, metrics = train_step(init_fn(0))
    return state, metrics


def test_microbatched_update_matches_default():
    """Gradient accumulation over micro-batches (advantages normalised over
    the full minibatch first) is the same update as the one-shot
    minibatch, up to float summation order."""
    s1, m1 = _breakout_ppo(1)
    p1 = {k: v.clone() for k, v in s1.module.state_dict().items()}
    s2, m2 = _breakout_ppo(2)
    for k, v in s2.module.state_dict().items():
        np.testing.assert_allclose(v.numpy(), p1[k].numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)
    for k in ppo.METRICS:
        np.testing.assert_allclose(float(m2[k]), float(m1[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    assert s1.update == s2.update == 1


def test_ppo_learns_identity():
    """tests/test_rl_learning.py:28-36 in the port."""
    env = make_discrete_identity_env(16, dim=4, device="cpu")
    init_fn, step, _ = ppo.make_ppo(env, network="mlp", nsteps=16,
                                    nminibatches=2, noptepochs=2, lr=1e-2,
                                    cliprange=0.2, total_updates=60,
                                    network_kwargs=dict(num_hidden=32),
                                    device="cpu")
    state = init_fn(0)
    for _ in range(60):
        state, metrics = step(state)
    r = float(metrics["mean_reward"])
    assert r > 0.8, f"ppo failed to learn identity: {r}"


def test_optimizer_matches_optax_steps():
    """clip_by_global_norm -> scale_by_adam(eps=1e-5) -> scale(-lr) on the
    same gradients as optax, three steps, one of them clipped."""
    import optax
    r = np.random.default_rng(1)
    params = [r.normal(size=(3, 4)).astype(np.float32),
              r.normal(size=(4,)).astype(np.float32)]
    tx = optax.chain(optax.clip_by_global_norm(0.5),
                     optax.scale_by_adam(eps=1e-5), optax.scale(-1.0))
    jp = [jnp.asarray(p) for p in params]
    js = tx.init(jp)
    tp = [torch.as_tensor(p.copy()) for p in params]
    adam = ppo.AdamState.zeros_like(tp)
    for i, scale in enumerate((0.01, 3.0, 0.1)):
        grads = [(r.normal(size=p.shape) * scale).astype(np.float32)
                 for p in params]
        u, js = tx.update([jnp.asarray(g) for g in grads], js, jp)
        jp = [p + v * 2.5e-4 for p, v in zip(jp, u)]
        g = ppo.clip_by_global_norm([torch.as_tensor(g) for g in grads],
                                    0.5)
        ppo.adam_update(tp, g, adam, 2.5e-4)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-8, err_msg=f"step {i}")


def test_anneal_and_recurrent_and_mesh_refusals():
    assert ppo.anneal(0, 4, 2.5e-4, 0.1) == (float(np.float32(2.5e-4)),
                                             float(np.float32(0.1)))
    lr, clip = ppo.anneal(3, 4, 2.5e-4, 0.1)
    assert lr == float(np.float32(2.5e-4) * np.float32(0.25))
    assert ppo.anneal(9, 4, 2.5e-4, 0.1)[1] == float(
        np.float32(0.1) * np.float32(0.01))
    env = make_discrete_identity_env(2, dim=3, device="cpu")
    # a recurrent network trains with ppo_recurrent, as in JAX
    from toybox_tpu_torch.rl.ppo_recurrent import RecurrentPPOState
    state = ppo.learn(env=env, network="lstm", nsteps=2, nminibatches=2,
                      noptepochs=1, total_timesteps=4, nlstm=4,
                      network_kwargs=dict(num_hidden=4), device="cpu")
    assert isinstance(state, RecurrentPPOState) and state.update == 1
    # mesh= trains (here a mesh of one rank: every collective the
    # identity), as without it; a recurrent network under mesh= raises
    from toybox_tpu_torch.parallel.mesh import make_mesh
    kw = dict(network="mlp", nsteps=2, nminibatches=2, noptepochs=1,
              total_timesteps=8, network_kwargs=dict(num_hidden=4),
              device="cpu")
    states = [ppo.learn(env=make_discrete_identity_env(2, dim=3,
                                                       device="cpu"),
                        mesh=mesh, **kw) for mesh in (None, make_mesh())]
    assert states[1].update == states[0].update == 2
    for k, v in states[0].module.state_dict().items():
        torch.testing.assert_close(states[1].module.state_dict()[k], v,
                                   rtol=0, atol=1e-7)
    with pytest.raises(ValueError, match="ppo_recurrent.learn"):
        ppo.learn(env=env, network="lstm", mesh=make_mesh(), device="cpu")


def test_distributions():
    assert make_pdtype(6)[0] == 6
    with pytest.raises(NotImplementedError):
        make_pdtype(object())
    logits = torch.tensor([[0.0, 0.0, 10.0], [10.0, 0.0, 0.0]])
    assert gumbel_max(logits, torch.zeros(2, 3)).tolist() == [2, 0]
    assert gumbel_max(logits, torch.tensor([[20.0, 0, 0], [0, 0, 0]])
                      ).tolist() == [0, 0]
    g = torch.Generator().manual_seed(0)
    draws = CategoricalPd(torch.zeros(4000, 3)).sample(g)
    assert abs(float((draws == 1).float().mean()) - 1 / 3) < 0.03


def _tiny_cli(tmp_path, *extra):
    return ["--alg=ppo", "--env=BreakoutToyboxNoFrameskip-v4",
            "--num_envs=2", f"--num_timesteps={2 * 4 * 4 * 2}",
            "--nsteps=4", "--nminibatches=2", "--noptepochs=1",
            "--device=cpu", f"--log_path={tmp_path / 'log'}", *extra]


def test_run_main_trains_saves_and_logs(tmp_path, capsys):
    path = tmp_path / "model"
    state = run.main(_tiny_cli(tmp_path, f"--save_path={path}"))
    assert state.update == 2
    module, _, _, _ = build_policy((84, 84, 4), 4, "cnn", device="cpu")
    ppo.load_params(path, module)
    for k, v in module.state_dict().items():
        assert torch.equal(v, state.module.state_dict()[k]), k
    with open(tmp_path / "log" / "progress.csv") as f:
        rows = list(csv.DictReader(f))
    assert [float(r["misc/nupdates"]) for r in rows] == [1.0, 2.0]
    assert np.isfinite(float(rows[-1]["loss/policy_loss"]))
    assert "loss/value_loss" in capsys.readouterr().out


def test_run_main_refuses_other_algs_and_plays(tmp_path, monkeypatch,
                                               capsys):
    with pytest.raises(ValueError, match="unknown alg"):
        run.main(_tiny_cli(tmp_path, "--alg=nope"))
    with monkeypatch.context() as m:       # the tensorboard format
        m.setenv("TOYBOX_LOG_FORMAT", "tensorboard")
        run.main(_tiny_cli(tmp_path, f"--log_path={tmp_path / 'tblog'}"))
        assert any(f.startswith("events.out.tfevents") for f in
                   os.listdir(tmp_path / "tblog" / "tb"))
    with pytest.raises(ValueError, match="toybox_tpu_torch.rl.her.learn"):
        run.main(_tiny_cli(tmp_path, "--alg=her"))
    with pytest.raises(ValueError, match="toybox_tpu_torch.rl.ddpg.learn"):
        run.main(_tiny_cli(tmp_path, "--alg=ddpg"))
    with pytest.raises(ValueError, match="key=value"):
        run.main(_tiny_cli(tmp_path, "--oops"))
    monkeypatch.setattr(run, "play", functools.partial(
        run.play, n_envs=2, max_chunks=1, chunk=3))
    state = run.main(_tiny_cli(tmp_path, "--play", "--alg=ppo2"))
    assert state.update == 2
    capsys.readouterr()
    args = run.common_arg_parser().parse_args(["--device=cpu"])
    returns = run.play(args, state)
    assert capsys.readouterr().out.count("episode_rew=") == len(returns)


def test_checkpointer_resumes_training(tmp_path):
    env = make_discrete_identity_env(4, dim=3, device="cpu")
    kw = dict(env=env, network="mlp", nsteps=4, nminibatches=2,
              noptepochs=1, checkpoint_path=str(tmp_path), checkpoint_freq=1,
              device="cpu", network_kwargs=dict(num_hidden=8))
    s2 = ppo.learn(total_timesteps=2 * 16, **kw)
    assert latest_checkpoint(str(tmp_path)).endswith("ckpt_2")
    # resumed: a fresh learn to 3 updates starts at update 2's state
    env2 = make_discrete_identity_env(4, dim=3, device="cpu")
    s3 = ppo.learn(total_timesteps=3 * 16, **dict(kw, env=env2))
    assert s3.update == 3 and s3.adam.count == 3 * 2
    ck = Checkpointer(str(tmp_path), 1)
    fresh_env = make_discrete_identity_env(4, dim=3, device="cpu")
    init_fn, _, _ = ppo.make_ppo(fresh_env, network="mlp", nsteps=4,
                                 nminibatches=2, noptepochs=1, device="cpu",
                                 network_kwargs=dict(num_hidden=8))
    restored = ck.restore(init_fn(5))
    assert restored.update == 3
    for k, v in restored.module.state_dict().items():
        assert torch.equal(v, s3.module.state_dict()[k]), k
    assert s2.update == 2


def test_logger_formats(tmp_path):
    lg = logger.configure(dir=str(tmp_path), format_strs=["json", "csv",
                                                          "log"])
    logger.logkv("a", 1.5)
    logger.logkv("m", 1)
    logger.logkv("m", 2.0)
    assert logger.dumpkvs() == {"a": 1.5, "m": 2.0}
    logger.logkv("b", "x,y")
    logger.dumpkvs()
    lg.close()
    with open(tmp_path / "progress.csv") as f:
        rows = list(csv.reader(f))
    assert rows == [["a", "m", "b"], ["1.5", "2.0", ""], ["", "", "x,y"]]
    with open(tmp_path / "progress.json") as f:
        assert f.readline().strip() == '{"a": 1.5, "m": 2.0}'
    assert "| a " in (tmp_path / "log.txt").read_text()
    # the tensorboard format is a known one now (run.main's test below
    # writes its event file; tests/test_torch_surface.py reads it back)
    assert "tensorboard" in logger._WRITERS
    with pytest.raises(ValueError):
        logger.make_output_format("nope", str(tmp_path))


@pytest.mark.parametrize("model", ["Breakout.regress.model",
                                   "SpaceInvaders.regress.model",
                                   "Amidar.regress.model"])
def test_writer_reproduces_the_committed_models(model, tmp_path):
    """Read, carried into the port's policy and written back, each
    committed JAX model gives the same bytes."""
    from toybox_tpu_torch.rl.checkpoint import (load_state_dict, packb,
                                                params_to_flax)
    with open(f"models/{model}", "rb") as f:
        want = f.read()
    assert packb(params_to_flax(load_state_dict(f"models/{model}"))) == want
