"""The port's GAIL and behavior cloning (toybox_tpu_torch.rl.gail) against
the JAX package's.

- ``Discriminator`` and ``logit_bernoulli_entropy`` against flax's, on
  uint8 frames and on float vectors: logits and the gradients of a
  weighted sum of them, the weights carried across with
  ``checkpoint.dense_stack_from_flax`` (whose inverse gives the tree
  back exactly).
- ``behavior_clone`` fed JAX's initial params and epoch permutations
  (100 samples in minibatches of 32: each epoch's tail wrapped by 28):
  params within 1e-6 absolute, the last epoch's loss within 1e-5.
- One ``make_gail`` update (the PPO generator) and one ``make_gail_trpo``
  train step (rollout, trust-region update, value steps, a discriminator
  step), each against JAX's from ``init_fn(0)`` on the identity env (mlp,
  4 envs x 8 steps), the JAX params carried across, JAX's rollout
  replayed with its key schedule and played back, and its Gumbel noise
  and expert indices fed in. The discriminator, value network and PPO
  generator steps within 1e-6 absolute (params and Adam moments, as
  PPO's); the TRPO step within 1e-3 of its largest move after checking
  that no line-search comparison is a near tie, and ``accepted`` equal,
  as tests/test_torch_trpo.py holds TRPO (ten CG iterations carry
  float-order differences; JAX's own f32 step is 1.5e-4 of its move off
  the float64 one); metrics within 1e-5 relative or 1e-6 absolute (kl
  and the surrogate gain at 1e-3).
- The learning tests of tests/test_rl_learning.py:156-190,329-375 at
  JAX's thresholds, on the port's identity env with its own draws.
- ``run.main --alg=gail`` on the CPU: BC only (``--num_timesteps=0
  --bc_epochs=1``) and one adversarial update; each saved file read by
  JAX's ``load_params`` and by ``load_eval_params("gail", ...)``, and
  ``--load_path`` (the expert) not loaded into the policy.
- (The expert pipeline: tests/test_torch_gail_expert.py.)
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests.test_torch_codecs import one_torch_thread  # noqa: F401
from tests.test_torch_dqn import _assert_close, _assert_named, _np, _t
from tests.test_torch_ppo1 import _adam, _closure, playback_env
from tests.test_torch_trpo import TR_RTOL, _assert_step, _check_no_near_tie
from toybox_tpu.rl import gail as jgail
from toybox_tpu.rl import ppo as jppo
from toybox_tpu.rl.policies import build_policy as j_build_policy
from toybox_tpu.rl.test_envs import make_discrete_identity_env as j_identity
from toybox_tpu_torch import run
from toybox_tpu_torch.rl import gail, trpo
from toybox_tpu_torch.rl.checkpoint import (dense_stack_from_flax,
                                            dense_stack_to_flax,
                                            load_state_dict,
                                            params_from_flax)
from toybox_tpu_torch.rl.distributions import gumbel, gumbel_max
from toybox_tpu_torch.rl.eval_adapter import load_eval_params
from toybox_tpu_torch.rl.test_envs import make_discrete_identity_env

DIM = 4
NENVS, NSTEPS, HIDDEN = 4, 8, 16


@pytest.mark.parametrize("frames", [True, False])
def test_discriminator_matches_flax(frames):
    r = np.random.default_rng(int(frames))
    shape, nact, n = ((6, 7, 2), 4, 5) if frames else ((3,), 3, 6)
    obs = (r.integers(0, 256, (n,) + shape).astype(np.uint8) if frames
           else r.normal(size=(n,) + shape).astype(np.float32))
    onehot = np.eye(nact, dtype=np.float32)[r.integers(0, nact, n)]
    w = r.normal(size=n).astype(np.float32)
    jd = jgail.Discriminator()
    params = jd.init(jax.random.PRNGKey(3), jnp.zeros((1,) + shape),
                     jnp.zeros((1, nact)))
    back = dense_stack_to_flax(dense_stack_from_flax(_np(params)))
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        np.array_equal, back, _np(params)))

    def f(p):
        return jnp.sum(jd.apply(p, jnp.asarray(obs), onehot) * w)

    jlogit = np.asarray(jd.apply(params, jnp.asarray(obs), onehot))
    jgrad = dense_stack_from_flax(_np(jax.grad(f)(params)))
    disc = gail.Discriminator(shape, nact)
    disc.load_state_dict(dense_stack_from_flax(_np(params)))
    logit = disc(_t(obs), _t(onehot))
    np.testing.assert_allclose(logit.detach().numpy(), jlogit, rtol=1e-5,
                               atol=1e-6)
    names = [k for k, _ in disc.named_parameters()]
    grads = torch.autograd.grad((logit * _t(w)).sum(),
                                list(disc.parameters()))
    for k, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), jgrad[k].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    z = np.concatenate([jlogit, [-40.0, -3.0, 0.0, 5.0, 40.0]]).astype(
        np.float32)
    np.testing.assert_allclose(
        gail.logit_bernoulli_entropy(_t(z)).numpy(),
        np.asarray(jgail.logit_bernoulli_entropy(jnp.asarray(z))),
        rtol=1e-6, atol=1e-7)


def _identity_expert(n=2048, seed=0):
    """tests/test_rl_learning.py's expert for the identity task, numpy."""
    targets = np.array(jax.random.randint(jax.random.PRNGKey(seed), (n,), 0,
                                          DIM))
    return np.eye(DIM, dtype=np.float32)[targets], targets


def test_behavior_clone_matches_jax():
    n, bs, epochs, seed = 100, 32, 3, 0
    eobs, eacts = _identity_expert(n)
    env = j_identity(8, dim=DIM)
    kw = dict(network="mlp", epochs=epochs, batch_size=bs, lr=1e-2,
              seed=seed, network_kwargs=dict(num_hidden=HIDDEN))
    jparams, jloss = jgail.behavior_clone(env, eobs, eacts, **kw)
    key, pkey = jax.random.split(jax.random.PRNGKey(seed))
    init = j_build_policy((DIM,), DIM, "mlp", num_hidden=HIDDEN)[1](pkey)
    perms = np.stack([np.asarray(jax.random.permutation(k, n))
                      for k in jax.random.split(key, epochs)])
    module, loss = gail.behavior_clone(
        make_discrete_identity_env(8, dim=DIM, device="cpu"), _t(eobs),
        _t(eacts), device="cpu",
        draws=dict(perms=_t(perms), init=params_from_flax(_np(init))), **kw)
    _assert_named(module.state_dict(), jparams, "bc params")
    _assert_close(loss, jloss, "bc loss")


def _replay(env, logits_fn, nsteps):
    """JAX's rollout of a GAIL update replayed with its key schedule (a
    split a step, the actions argmax(logits + gumbel)): the run (frames,
    rewards, dones, episode returns and lengths, actions, the Gumbel
    noise) and the key after it."""

    @jax.jit
    def replay(params, env_state, key):
        def body(carry, _):
            env_state, key = carry
            obs = env_state.frames
            key, akey = jax.random.split(key)
            logits = logits_fn(params, obs)
            g = jax.random.gumbel(akey, logits.shape, jnp.float32)
            actions = jnp.argmax(logits + g, axis=-1)
            env_state, _, rewards, dones, info = env.step(env_state,
                                                          actions)
            return (env_state, key), (obs, rewards, dones,
                                      info["episode_return"],
                                      info["episode_length"], actions, g)

        (env_state, key), traj = jax.lax.scan(
            body, (env_state, key), None, length=nsteps)
        return traj, env_state.frames, key

    def run_(params, env_state, key):
        traj, last, key = _np(replay(params, env_state, key))
        obs, rewards, dones, ep_ret, ep_len, actions, g = traj
        return dict(frames=np.concatenate([obs, last[None]]),
                    rewards=rewards, dones=dones, ep_ret=ep_ret,
                    ep_len=ep_len, actions=actions, gumbel=g), key

    return run_


def _expert_idx(key, steps, n_expert):
    """The expert indices of ``steps`` discriminator steps from ``key``
    (key, dkey = split(key) a step), and the key after them."""
    out = []
    for _ in range(steps):
        key, dkey = jax.random.split(key)
        out.append(np.asarray(jax.random.randint(dkey, (NENVS * NSTEPS,), 0,
                                                 n_expert)))
    return np.stack(out), key


def _assert_adam(adam, opt_state, module, what):
    want = _adam(opt_state)
    assert adam.count == int(want.count), what
    names = [n for n, _ in module.named_parameters()]
    for k, got in (("mu", adam.mu), ("nu", adam.nu)):
        _assert_named(dict(zip(names, got)), getattr(want, k),
                      f"{what} {k}")


def _assert_disc(disc, adam, jparams, jopt):
    want = dense_stack_from_flax(_np(jparams))
    for k, v in want.items():
        np.testing.assert_allclose(disc.state_dict()[k].numpy(), v.numpy(),
                                   rtol=0, atol=1e-6, err_msg=f"disc {k}")
    j = _adam(jopt)
    assert adam.count == int(j.count)
    names = [n for n, _ in disc.named_parameters()]
    for what, got in (("mu", adam.mu), ("nu", adam.nu)):
        want = dense_stack_from_flax(_np(getattr(j, what)))
        for n, g in zip(names, got):
            np.testing.assert_allclose(g.numpy(), want[n].numpy(), rtol=0,
                                       atol=1e-6, err_msg=f"disc {what} {n}")


def test_gail_ppo_generator_update_matches_jax():
    eobs, eacts = _identity_expert(256)
    jenv = j_identity(NENVS, dim=DIM, episode_len=5)
    kw = dict(network="mlp", nsteps=NSTEPS, disc_steps=2,
              network_kwargs=dict(num_hidden=HIDDEN))
    init_fn, train_step = jgail.make_gail(jenv, eobs, eacts, **kw)
    s0 = jax.jit(init_fn, static_argnums=0)(0)
    p_step = _closure(train_step, "p_step")
    run0, key = _replay(jenv, lambda p, o: p_step(p, o, jax.random.PRNGKey(
        0))[3], NSTEPS)(s0.pi_params, s0.env_state, s0.key)
    idx, _ = _expert_idx(key, 2, 256)
    s1, jm = jax.jit(train_step)(s0)
    env = playback_env(run0, DIM, 1)
    tinit, step = gail.make_gail(env, eobs, eacts, device="cpu", **kw)
    st = tinit(0)
    st.module.load_state_dict(params_from_flax(_np(s0.pi_params)))
    st.disc.load_state_dict(dense_stack_from_flax(_np(s0.disc_params)))
    collected = step.collect(st, {"gumbel": _t(run0["gumbel"])})
    np.testing.assert_array_equal(collected[0].actions.numpy(),
                                  run0["actions"])
    st, m = step.optimize(st, collected, {"expert_idx": _t(idx)})
    _assert_named(st.module.state_dict(), s1.pi_params, "pi")
    _assert_adam(st.pi_adam, s1.pi_opt, st.module, "pi")
    _assert_disc(st.disc, st.disc_adam, s1.disc_params, s1.disc_opt)
    assert set(m) == set(jm)
    for k, v in _np(jm).items():
        _assert_close(m[k], v, k)


def test_gail_trpo_train_step_matches_jax():
    eobs, eacts = _identity_expert(256)
    jenv = j_identity(NENVS, dim=DIM, episode_len=5)
    kw = dict(network="mlp", nsteps=NSTEPS, disc_steps=2,
              network_kwargs=dict(num_hidden=HIDDEN))
    init_fn, train_step, rollout_step, _, _ = jgail.make_gail_trpo(
        jenv, eobs, eacts, **kw)
    s0 = jax.jit(init_fn, static_argnums=0)(0)
    pi_step = _closure(rollout_step, "pi_step")
    run0, key = _replay(jenv, lambda p, o: pi_step(p, o, jax.random.PRNGKey(
        0))[3], NSTEPS)(s0.pi_params, s0.env_state, s0.key)
    idx, _ = _expert_idx(key, 2, 256)
    s1, jm = jax.jit(train_step)(s0)
    env = playback_env(run0, DIM, 1)
    tinit, step = gail.make_gail_trpo(env, eobs, eacts, device="cpu",
                                      **kw)
    st = tinit(0)
    before = params_from_flax(_np(s0.pi_params))
    st.module.load_state_dict(before)
    st.vf.load_state_dict(params_from_flax(_np(s0.vf_params)))
    st.disc.load_state_dict(dense_stack_from_flax(_np(s0.disc_params)))
    collected = step.collect(st, {"gumbel": _t(run0["gumbel"])})
    fobs, facts, fadv, fnlp, _ = collected[0]
    np.testing.assert_array_equal(facts.numpy(), run0["actions"].reshape(-1))
    # the line search's record, on a copy: no comparison is a near tie
    _, search = trpo.trust_region_update(
        copy.deepcopy(st.module), DIM, fobs, facts, fadv, fnlp, max_kl=0.01)
    _check_no_near_tie(search, bool(jm["accepted"]), 0.01)
    st, m = step.optimize(st, collected, {"expert_idx": _t(idx)})
    assert float(m["accepted"]) == float(jm["accepted"]) == 1.0
    _assert_step(st.module.state_dict(), params_from_flax(_np(s1.pi_params)),
                 before, TR_RTOL, "pi")
    _assert_named(st.vf.state_dict(), s1.vf_params, "vf")
    _assert_adam(st.vf_adam, s1.vf_opt, st.vf, "vf")
    _assert_disc(st.disc, st.disc_adam, s1.disc_params, s1.disc_opt)
    assert set(m) == set(jm) and st.update == int(s1.update) == 1
    for k, v in _np(jm).items():
        if k in ("kl", "surrogate_gain"):
            np.testing.assert_allclose(float(m[k]), float(v), rtol=TR_RTOL,
                                       err_msg=k)
        else:
            _assert_close(m[k], v, k)


# ---------------------------------------------------------------------------
# Learning (tests/test_rl_learning.py, the port's envs and draws)
# ---------------------------------------------------------------------------

def _torch_expert(n=2048, seed=0):
    targets = torch.randint(0, DIM, (n,),
                            generator=torch.Generator().manual_seed(seed))
    return F.one_hot(targets, DIM).float(), targets


def test_gail_imitates_identity_expert():
    """tests/test_rl_learning.py:156-190 in the port."""
    eobs, eacts = _torch_expert()
    env = make_discrete_identity_env(16, dim=DIM, device="cpu")
    init_fn, step = gail.make_gail(env, eobs, eacts, network="mlp",
                                   nsteps=16, gamma=0.1, lam=0.5, pi_lr=5e-3,
                                   network_kwargs=dict(num_hidden=32),
                                   device="cpu")
    state = init_fn(0)
    for _ in range(300):
        state, metrics = step(state)
    st, _ = env.reset(torch.arange(16))
    gen = torch.Generator().manual_seed(1)
    correct = 0.0
    for _ in range(20):
        with torch.no_grad():
            logits = state.module(st.frames)[0]
        acts = gumbel_max(logits, gumbel(logits.shape, gen, "cpu"))
        st, _, rew, _, _ = env.step(st, acts)
        correct += float(rew.sum())
    acc = correct / (20 * 16)
    assert acc > 0.7, f"GAIL imitation accuracy {acc}"


def test_gail_trpo_discriminator_reward_is_load_bearing():
    """tests/test_rl_learning.py:335-361 in the port: with the adversarial
    reward the identity expert is imitated; with reward_scale=0 the
    learner stays near chance."""
    eobs, eacts = _torch_expert()
    env = make_discrete_identity_env(16, dim=DIM, device="cpu")

    def final_true_reward(reward_scale):
        init_fn, step = gail.make_gail_trpo(
            env, eobs, eacts, network="mlp", nsteps=16, gamma=0.1, lam=0.5,
            max_kl=0.05, reward_scale=reward_scale, disc_lr=1e-3,
            disc_steps=2, network_kwargs=dict(num_hidden=32), device="cpu")
        state = init_fn(0)
        rs = []
        for _ in range(120):
            state, m = step(state)
            rs.append(float(m["true_reward"]))
        return sum(rs[-20:]) / 20

    with_d = final_true_reward(1.0)
    without_d = final_true_reward(0.0)
    assert with_d > 0.6, f"gail-trpo failed to imitate: {with_d}"
    assert without_d < 0.45, f"ablation unexpectedly learned: {without_d}"
    assert with_d > without_d + 0.2


def test_behavior_clone_pretrains_policy():
    """tests/test_rl_learning.py:364-375 in the port."""
    eobs, eacts = _torch_expert()
    env = make_discrete_identity_env(8, dim=DIM, device="cpu")
    module, bc_loss = gail.behavior_clone(
        env, eobs, eacts, network="mlp", epochs=300, lr=1e-2,
        network_kwargs=dict(num_hidden=32), device="cpu")
    assert bc_loss < 0.2, f"bc loss too high: {bc_loss}"
    with torch.no_grad():
        logits = module(torch.eye(DIM))[0]
    acc = float((logits.argmax(-1) == torch.arange(DIM)).float().mean())
    assert acc == 1.0, f"bc policy inaccurate: {acc}"


# ---------------------------------------------------------------------------
# run.main --alg=gail
# ---------------------------------------------------------------------------

EXPERT = "models/Breakout.ppo1.model"


@pytest.mark.parametrize("args,network,updates", [
    (["--num_timesteps=0", "--bc_epochs=1", "--network=cnn"], "cnn", 0),
    (["--num_timesteps=32", "--nsteps=4", "--g_step=1", "--max_kl=0.001",
      "--log_interval=1"], "cnn_small", 1),
])
def test_run_main_trains_and_saves_gail(args, network, updates, tmp_path):
    path = str(tmp_path / "gail.model")
    state = run.main(["--alg=gail", "--env=BreakoutToyboxNoFrameskip-v4",
                      "--num_envs=2", "--n_expert_transitions=8",
                      f"--load_path={EXPERT}", "--device=cpu",
                      f"--save_path={path}",
                      f"--log_path={tmp_path / 'log'}"] + args)
    assert state.update == updates
    if updates:
        assert set(state.disc_metrics) == {"disc_loss", "disc_acc"}
        assert state.disc_adam.count == 1
    template = j_build_policy((84, 84, 4), 4, network)[1](
        jax.random.PRNGKey(0))
    back = params_from_flax(_np(jppo.load_params(path, template)))
    head = load_eval_params("gail", network, path, "breakout", device="cpu")
    for k, v in state.module.state_dict().items():
        assert torch.equal(back[k], v), k
        assert torch.equal(head.state_dict()[k], v), k
    # --load_path is the expert, not a warm start
    # (a cnn_small policy could not even load the NatureCNN expert)
    if network == "cnn":
        expert = load_state_dict(EXPERT)
        assert max(float((expert[k] - v).abs().max()) for k, v in
                   state.module.state_dict().items()) > 0.05
    with pytest.raises(TypeError, match="unexpected"):
        gail.learn(env=make_discrete_identity_env(2, dim=3, device="cpu"),
                   expert_path="x.npz", generator="ppo", max_kl=0.1,
                   device="cpu")
