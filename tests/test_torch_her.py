"""The port's HER (toybox_tpu_torch.rl.her) against the JAX package's.

- The bit-flip and point-goal envs' contracts, and their steps fed the
  JAX envs' resets (and the bit-flip env's auto-reset draws): the same
  bits, positions, rewards and dones.
- Three cycles of ``make_her`` (4 envs, 4 bits, a ring of 2 episodes,
  batches of 16, a target sync every 2 cycles: a sync and a wrap of the
  ring inside the three) and three of ``make_her_ddpg`` (4 envs, dim 2,
  episodes of 5 steps, a ring of 2, two SGD batches of 16 a cycle), the
  networks at the JAX defaults' widths, against JAX's ``cycle`` from
  ``init_fn(0)`` with the JAX params carried across. JAX's draws are
  replayed with its key schedule and fed as ``draws``. Compared after
  each cycle: the params, the targets, the Adam states, the normalizers,
  the ring and the metrics. Tolerance: params and moments within 1e-6
  absolute, as PPO's and DDPG's; the metrics within 1e-5 relative or
  1e-6 absolute. HER-DDPG's 256-wide layers leave a few weights with
  gradients too weak for that (NOISE_RATIO below): those are held within
  the Adam step bound, and each DDPG cycle starts from JAX's state before
  it, so that their drift does not reach the next cycle's rollout.
- The learning tests tests/test_rl_learning.py:144 (bit-flip success
  > 0.5 after 400 cycles) and :298 (future > 0.5, none < 0.25, future >
  none + 0.3) at JAX's thresholds and settings, ``learn`` for both
  backends, and ``run.main --alg=her``'s ValueError.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_codecs import one_torch_thread  # noqa: F401
from tests.test_torch_dqn import _Rows, _assert_close, _np, _t
from tests.test_torch_ppo1 import _adam
from toybox_tpu.rl import her as jher
from toybox_tpu_torch import run
from toybox_tpu_torch.rl import her
from toybox_tpu_torch.rl.checkpoint import dense_stack_from_flax

NENVS, NBITS, DIM, EP_LEN, CAP, BATCH = 4, 4, 2, 5, 2, 16


def test_bitflip_env_contract_and_jax_resets():
    reset, step, n = her.make_bitflip_env(3, n_bits=4, device="cpu")
    assert n == 4
    st, obs = reset(torch.arange(3))
    st2, _ = reset(torch.tensor([2, 1, 0]))          # the sum seeds it
    assert torch.equal(st.bits, st2.bits) and obs.shape == (3, 8)
    # flip bit i; a solved env freezes; done at n_bits steps
    goal = torch.tensor([[1, 0, 0, 0]] * 3, dtype=torch.bool)
    st, _ = reset(0, start=(torch.zeros(3, 4, dtype=torch.bool), goal))
    for t, a in enumerate(([0, 1, 1], [2, 1, 1], [3, 0, 2], [1, 0, 3])):
        st, obs, rew, done, info = step(st, torch.tensor(a),
                                        auto_reset=False)
        if t == 0:
            assert rew.tolist() == [0.0, -1.0, -1.0]
            assert done.tolist() == [True, False, False]
    assert st.bits[0].tolist() == [True, False, False, False]  # frozen
    assert bool(done.all()) and int(st.t.max()) == 4
    # fed the JAX env's reset and auto-reset draws: the same trajectory
    jreset, jstep, _ = jher.make_bitflip_env(3, 4)
    jst, jobs = jreset(jnp.arange(3, dtype=jnp.uint32))
    st, obs = reset(0, start=(_t(jst.bits), _t(jst.goal)))
    np.testing.assert_array_equal(obs.numpy(), np.asarray(jobs))
    acts = np.random.default_rng(0).integers(0, 4, (12, 3))
    for a in acts:
        _, k1, k2 = jax.random.split(jst.key, 3)
        fresh = (_t(jax.random.bernoulli(k1, 0.5, (3, 4))),
                 _t(jax.random.bernoulli(k2, 0.5, (3, 4))))
        jst, jobs, jr, jd, jinfo = jstep(jst, jnp.asarray(a))
        st, obs, rew, done, info = step(st, torch.as_tensor(a), fresh=fresh)
        np.testing.assert_array_equal(obs.numpy(), np.asarray(jobs))
        np.testing.assert_array_equal(rew.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(done.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(st.t.numpy(), np.asarray(jst.t))
        for k in ("achieved", "solved"):
            np.testing.assert_array_equal(info[k].numpy(),
                                          np.asarray(jinfo[k]))


def test_point_goal_env_contract_and_jax_resets():
    reset, step, is_success, T = her.make_point_goal_env(3, device="cpu")
    assert T == 20
    st = reset(torch.arange(3))
    assert bool((st.pos >= -1).all() and (st.goal < 1).all())
    for t in range(1, T + 1):
        st, rew, done = step(st, torch.full((3, 2), 5.0))   # clipped
        assert bool(done.all()) == (t == T)
    assert torch.equal(st.pos, torch.ones(3, 2))            # in the box
    jreset, jstep, jsucc, _ = jher.make_point_goal_env(3, 2, 6)
    reset, step, is_success, _ = her.make_point_goal_env(3, 2, 6,
                                                         device="cpu")
    jst = jreset(jnp.arange(3, dtype=jnp.uint32))
    st = reset(0, start=(_t(jst.pos), _t(jst.goal)))
    acts = np.random.default_rng(1).uniform(-1.5, 1.5, (6, 3, 2))
    acts = acts.astype(np.float32)
    for a in acts:
        jst, jr, jd = jstep(jst, jnp.asarray(a))
        st, rew, done = step(st, _t(a))
        np.testing.assert_allclose(st.pos.numpy(), np.asarray(jst.pos),
                                   rtol=0, atol=1e-7)
        np.testing.assert_array_equal(rew.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(done.numpy(), np.asarray(jd))
    assert is_success(st.goal, st.goal).all()


def _assert_dense(module, want_tree, what, atol=1e-6, noise=None):
    """The module's params against the flax tree's within ``atol``; the
    weights flagged in ``noise`` (name -> bool mask) within NOISE_ATOL."""
    want = dense_stack_from_flax(_np(want_tree))
    got = module.state_dict()
    assert set(got) == set(want), what
    for k, v in want.items():
        diff = (got[k].detach() - v).abs().numpy()
        if noise is not None and k in noise:
            weak = noise[k].numpy()
            assert diff[weak].max(initial=0) <= NOISE_ATOL, k
            diff = diff[~weak]
        assert diff.max(initial=0) <= atol, (
            f"{what} {k}: {diff.max()} > {atol}")


def _assert_adam(adam, module, jopt, count, what):
    jadam = _adam(jopt)
    assert adam.count == int(jadam.count) == count, what
    names = [n for n, _ in module.named_parameters()]
    for k in ("mu", "nu"):
        want = dense_stack_from_flax(_np(getattr(jadam, k)))
        for n, v in zip(names, getattr(adam, k)):
            np.testing.assert_allclose(v.numpy(), want[n].numpy(), rtol=0,
                                       atol=1e-6, err_msg=f"{what} {k} {n}")


def _samples(key, size, T, n_envs, batch):
    """One SGD batch's draws from ``key`` with JAX's key schedule."""
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    tt = jax.random.randint(k2, (batch,), 0, T)
    return {"ep": _t(jax.random.randint(k1, (batch,), 0, max(size, 1))),
            "tt": _t(tt),
            "en": _t(jax.random.randint(k3, (batch,), 0, n_envs)),
            "fut_off": _t(jax.random.randint(k4, (batch,), 0,
                                             jnp.maximum(T - tt, 1))),
            "her_u": _t(jax.random.uniform(k5, (batch,)))}


def test_her_dqn_cycles_match_jax():
    kw = dict(buffer_eps=CAP, batch_size=BATCH, target_update=2)
    init_fn, cycle, _ = jher.make_her(NENVS, NBITS, **kw)
    jreset = jher.make_bitflip_env(NENVS, NBITS)[0]
    states = [jax.jit(init_fn, static_argnums=0)(0)]
    step = jax.jit(cycle)
    draws, metrics = [], []
    for c in range(3):
        key, ekey = jax.random.split(states[-1].key)
        seeds = jax.random.randint(ekey, (NENVS,), 0, 2**31 - 1)
        jst, _ = jreset(seeds.astype(jnp.uint32))
        d = {"bits": _t(jst.bits), "goal": _t(jst.goal)}
        u, r = [], []
        for _ in range(NBITS):
            key, akey, rkey = jax.random.split(key, 3)
            r.append(jax.random.randint(rkey, (NENVS,), 0, NBITS))
            u.append(jax.random.uniform(akey, (NENVS,)))
        d["explore_u"], d["rand_actions"] = _t(jnp.stack(u)), _t(
            jnp.stack(r))
        key, k1, k2, k3, k4, k5 = jax.random.split(key, 6)
        tt = jax.random.randint(k2, (BATCH,), 0, NBITS)
        d.update(ep=_t(jax.random.randint(k1, (BATCH,), 0,
                                          min(c + 1, CAP))), tt=_t(tt),
                 en=_t(jax.random.randint(k3, (BATCH,), 0, NENVS)),
                 fut_off=_t(jax.random.randint(
                     k4, (BATCH,), 0, jnp.maximum(NBITS - tt, 1))),
                 her_u=_t(jax.random.uniform(k5, (BATCH,))))
        draws.append(d)
        s, m = step(states[-1])
        states.append(s)
        metrics.append(_np(m))
    tinit, tcycle, _ = her.make_her(NENVS, NBITS, device="cpu", **kw)
    st = tinit(0)
    for module in (st.qnet, st.target_qnet):
        module.load_state_dict(dense_stack_from_flax(_np(states[0].params)))
    syncs = 0
    for c, d in enumerate(draws):
        st, m = tcycle(st, d)
        want = states[c + 1]
        assert st.t == int(want.t) == c + 1
        _assert_dense(st.qnet, want.params, f"cycle {c} qnet")
        _assert_dense(st.target_qnet, want.target_params,
                      f"cycle {c} target")
        _assert_adam(st.adam, st.qnet, want.opt_state, c + 1, f"cycle {c}")
        jrb, rb = want.replay, st.replay
        assert (rb.cursor, rb.size) == (int(jrb.cursor), int(jrb.size))
        for k in ("bits", "goals", "actions"):
            np.testing.assert_array_equal(getattr(rb, k).numpy(),
                                          np.asarray(getattr(jrb, k)),
                                          err_msg=f"cycle {c} {k}")
        np.testing.assert_array_equal(st.env_state.bits.numpy(),
                                      np.asarray(want.env_state.bits))
        assert set(m) == set(metrics[c])
        for k, v in metrics[c].items():
            _assert_close(m[k], v, f"cycle {c} {k}")
        syncs += torch.equal(st.target_qnet.layers[0].weight,
                             st.qnet.layers[0].weight)
    assert syncs == 1                      # the target synced at cycle 2


DDPG_KW = dict(episode_len=EP_LEN, buffer_eps=CAP, batch_size=BATCH,
               n_batches=2)


def _jax_ddpg_cycles(n_cycles, kw):
    """JAX's states and metrics over ``n_cycles`` cycles from init_fn(0),
    and each cycle's draws replayed with its key schedule."""
    init_fn, cycle = jher.make_her_ddpg(NENVS, DIM, **kw)
    jreset = jher.make_point_goal_env(NENVS, DIM, EP_LEN)[0]
    states = [jax.jit(init_fn, static_argnums=0)(0)]
    step = jax.jit(cycle)
    draws, metrics = [], []
    for c in range(n_cycles):
        key, ekey = jax.random.split(states[-1].key)
        seeds = jax.random.randint(ekey, (NENVS,), 0, 2**31 - 1)
        jst = jreset(seeds.astype(jnp.uint32))
        d = {"pos": _t(jst.pos), "goal": _t(jst.goal)}
        noise, coin, rand_u = [], [], []
        for _ in range(EP_LEN):
            key, kn, kr, ku = jax.random.split(key, 4)
            noise.append(jax.random.normal(kn, (NENVS, DIM)))
            rand_u.append(jax.random.uniform(ku, (NENVS, DIM), jnp.float32,
                                             -1.0, 1.0))
            coin.append(jax.random.uniform(kr, (NENVS, 1)))
        d.update(noise=_t(jnp.stack(noise)), rand_coin=_t(jnp.stack(coin)),
                 rand_u=_t(jnp.stack(rand_u)))
        key, *bkeys = jax.random.split(key, 3)
        batches = [_samples(k, min(c + 1, CAP), EP_LEN, NENVS, BATCH)
                   for k in bkeys]
        d.update({k: torch.stack([b[k] for b in batches])
                  for k in batches[0]})
        draws.append(d)
        s, m = step(states[-1])
        states.append(s)
        metrics.append(_np(m))
    return states, draws, metrics


#: a weight whose gradient at an Adam step of the cycle is nonzero but
#: below NOISE_RATIO of its tensor's largest is weak there: JAX and torch
#: sum the 256-wide layers' gradients in other orders, which leaves such an
#: entry a relative error far above f32's, and Adam, which divides the
#: moments, turns it into the same relative error of a step of up to the
#: lr (optax.adam's eps 1e-8 turns a ~1e-9 noise gradient into a step of up
#: to the lr: ROADMAP hazards; an entry at 1.5e-5 of the largest ends 1e-6
#: apart). So a weak weight is held within NOISE_ATOL, twice the lr times
#: the cycle's two Adam steps, and fewer than NOISE_SHARE of the weights
#: may be weak
NOISE_RATIO, NOISE_SHARE = 1e-4, 0.05
NOISE_ATOL = 2 * 1e-3 * 2


def _load_jax_ddpg_state(st, jst):
    """Every tensor of a JAX HERDDPGState into the port's state ``st``."""
    for what in ("actor", "critic", "target_actor", "target_critic"):
        getattr(st, what).load_state_dict(
            dense_stack_from_flax(_np(getattr(jst, what))))
    for what in ("actor", "critic"):
        jadam = _adam(getattr(jst, f"opt_{what}"))
        names = [n for n, _ in getattr(st, what).named_parameters()]
        adam = getattr(st, f"{what}_adam")
        adam.count = int(jadam.count)
        for k in ("mu", "nu"):
            moments = dense_stack_from_flax(_np(getattr(jadam, k)))
            setattr(adam, k, [moments[n].clone() for n in names])
    for what in ("o_stats", "g_stats"):
        setattr(st, what, her.ObFilter(
            *(_t(getattr(getattr(jst, what), k))
              for k in ("mean", "var", "count"))))
    rb, jrb = st.replay, jst.replay
    for k in ("o", "ag", "g", "u"):
        getattr(rb, k).copy_(_t(getattr(jrb, k)))
    rb.cursor, rb.size = int(jrb.cursor), int(jrb.size)
    st.t = int(jst.t)


def test_her_ddpg_cycles_match_jax(monkeypatch):
    kw = DDPG_KW
    states, draws, metrics = _jax_ddpg_cycles(3, kw)
    tinit, tcycle = her.make_her_ddpg(NENVS, DIM, device="cpu", **kw)
    st = tinit(0)
    adam_update = her.ppo.adam_update

    def flag_noise(params, grads, *args, **kwargs):
        what = "actor" if params[0] is st.actor.layers[0].weight else \
            "critic"
        names = [n for n, _ in getattr(st, what).named_parameters()]
        for n, g in zip(names, grads):
            weak = (g != 0) & (g.abs() < NOISE_RATIO * g.abs().max())
            noise[what][n] = noise[what].get(n, weak) | weak
        return adam_update(params, grads, *args, **kwargs)

    monkeypatch.setattr(her.ppo, "adam_update", flag_noise)
    n_noise = n_all = 0
    for c, d in enumerate(draws):
        _load_jax_ddpg_state(st, states[c])
        noise = {"actor": {}, "critic": {}}
        st, m = tcycle(st, d)
        want = states[c + 1]
        assert st.t == int(want.t) == c + 1
        for what in ("actor", "critic", "target_actor", "target_critic"):
            _assert_dense(getattr(st, what), getattr(want, what),
                          f"cycle {c} {what}",
                          noise=noise[what.replace("target_", "")])
        for what in ("actor", "critic"):
            _assert_adam(getattr(st, f"{what}_adam"), getattr(st, what),
                         getattr(want, f"opt_{what}"), 2 * (c + 1),
                         f"cycle {c} {what}")
        for what in ("o_stats", "g_stats"):
            for k in ("mean", "var", "count"):
                np.testing.assert_allclose(
                    getattr(getattr(st, what), k).numpy(),
                    np.asarray(getattr(getattr(want, what), k)), rtol=0,
                    atol=1e-6, err_msg=f"cycle {c} {what} {k}")
        jrb, rb = want.replay, st.replay
        assert (rb.cursor, rb.size) == (int(jrb.cursor), int(jrb.size))
        for k in ("o", "ag", "g", "u"):
            np.testing.assert_allclose(getattr(rb, k).numpy(),
                                       np.asarray(getattr(jrb, k)), rtol=0,
                                       atol=1e-6, err_msg=f"cycle {c} {k}")
        assert set(m) == set(metrics[c])
        for k, v in metrics[c].items():
            _assert_close(m[k], v, f"cycle {c} {k}")
        n_noise += sum(int(v.sum()) for x in noise.values()
                       for v in x.values())
        n_all += sum(v.numel() for x in noise.values() for v in x.values())
    assert n_noise < NOISE_SHARE * n_all, (n_noise, n_all)


def test_her_learns_bitflip():
    """tests/test_rl_learning.py:144 in the port."""
    init_fn, cycle, _ = her.make_her(num_envs=16, n_bits=6, lr=1e-3,
                                     device="cpu")
    state = init_fn(0)
    for _ in range(400):
        state, last = cycle(state)
    sr = float(last["success_rate"])
    assert sr > 0.5, f"HER failed to learn bit-flipping: success {sr}"


def test_her_ddpg_relabeling_is_load_bearing():
    """tests/test_rl_learning.py:298 in the port: the future strategy
    solves the sparse point-goal task, the same learner without
    relabeling does not."""

    def final_success(strategy):
        init_fn, cycle = her.make_her_ddpg(16, 2, replay_strategy=strategy,
                                           device="cpu")
        state = init_fn(0)
        succ = []
        for _ in range(150):
            state, m = cycle(state)
            succ.append(float(m["success_rate"]))
        return sum(succ[-20:]) / 20

    future, plain = final_success("future"), final_success("none")
    assert future > 0.5, f"HER failed the point-goal task: {future}"
    assert plain < 0.25, f"ablation unexpectedly solved it: {plain}"
    assert future > plain + 0.3


@pytest.mark.parametrize("backend", ["dqn", "ddpg"])
def test_learn_logs_each_backend(backend):
    log = _Rows()
    state = her.learn(backend=backend, n_bits=4, num_envs=4,
                      total_episodes=4 * 4, episode_len=4, log_interval=2,
                      logger=log, device="cpu", unused_option=1)
    assert state.t == 4 and len(log.rows) == 2
    keys = ({"loss", "success_rate"} if backend == "dqn" else
            {"critic_loss", "actor_loss", "success_rate"})
    assert set(log.rows[0]) == keys
    assert all(np.isfinite(v) for r in log.rows for v in r.values())


def test_run_main_her_raises_jax_value_error():
    with pytest.raises(ValueError, match="toybox_tpu_torch.rl.her.learn"):
        run.main(["--alg=her", "--device=cpu"])
