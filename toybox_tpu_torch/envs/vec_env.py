"""VecEnv API surface (port of toybox_tpu.envs.vec_env; the reference's
baselines/common/vec_env package).

The reference scales env throughput with one OS process per env
(SubprocVecEnv / ShmemVecEnv over Pipes and shared memory). Here the
batched env (``envs.batched``) steps every env at once on the device, and
``BatchedVecEnv`` exposes it through the same VecEnv interface, with numpy
observations. ``SubprocVecEnv``/``ShmemVecEnv`` are also provided
literally for host-side envs that hold their own per-process state;
``DummyVecEnv`` is the serial loop. Dummy == Subproc == Shmem == Batched
is the reference's own vec-env consistency contract
(common/vec_env/test_vec_env.py).

A forked worker cannot use CUDA once the parent has touched it, so the
process executors keep the reference's ``context="fork"`` only for envs on
the CPU: with fork they build one env in the parent first and refuse an
env on ``cuda`` (pass ``context="spawn"`` for those).

Also: VecEnvWrapper, VecFrameStack, VecNormalize (running mean/std
normalization), VecMonitor, CloudpickleWrapper.
"""

from __future__ import annotations

import time
from abc import ABC, abstractmethod

import numpy as np
import torch


class AlreadySteppingError(Exception):
    pass


class NotSteppingError(Exception):
    pass


class VecEnv(ABC):
    """step_async/step_wait vectorized env ABC
    (reference vec_env/__init__.py:45-199)."""

    closed = False
    viewer = None

    def __init__(self, num_envs, observation_space, action_space):
        self.num_envs = num_envs
        self.observation_space = observation_space
        self.action_space = action_space

    @abstractmethod
    def reset(self):
        pass

    @abstractmethod
    def step_async(self, actions):
        pass

    @abstractmethod
    def step_wait(self):
        pass

    def close_extras(self):
        pass

    def close(self):
        if self.closed:
            return
        self.close_extras()
        self.closed = True

    def step(self, actions):
        self.step_async(actions)
        return self.step_wait()

    def render(self, mode="human"):
        raise NotImplementedError

    def get_images(self):
        raise NotImplementedError

    @property
    def unwrapped(self):
        return self


class VecEnvWrapper(VecEnv):
    def __init__(self, venv, observation_space=None, action_space=None):
        self.venv = venv
        super().__init__(venv.num_envs,
                         observation_space or venv.observation_space,
                         action_space or venv.action_space)

    def step_async(self, actions):
        self.venv.step_async(actions)

    @abstractmethod
    def reset(self):
        pass

    @abstractmethod
    def step_wait(self):
        pass

    def close(self):
        return self.venv.close()

    def render(self, mode="human"):
        return self.venv.render(mode)

    def __getattr__(self, name):
        return getattr(self.venv, name)

    @property
    def unwrapped(self):
        return self.venv.unwrapped


class CloudpickleWrapper:
    """Serialize env thunks with cloudpickle (reference
    vec_env/__init__.py); plain pickle fallback."""

    def __init__(self, x):
        self.x = x

    def __getstate__(self):
        try:
            import cloudpickle
            return cloudpickle.dumps(self.x)
        except ImportError:
            import pickle
            return pickle.dumps(self.x)

    def __setstate__(self, ob):
        import pickle
        self.x = pickle.loads(ob)

    def __call__(self):
        return self.x()


class DummyVecEnv(VecEnv):
    """Serial python loop over gymnasium envs with auto-reset on done
    (reference dummy_vec_env.py + the subproc worker's auto-reset
    semantics, subproc_vec_env.py:12-15)."""

    def __init__(self, env_fns):
        self.envs = [fn() for fn in env_fns]
        env = self.envs[0]
        super().__init__(len(env_fns), env.observation_space,
                         env.action_space)
        self.actions = None

    def reset(self, seed=None):
        obs = []
        for i, env in enumerate(self.envs):
            o, _ = env.reset(seed=None if seed is None else seed + i)
            obs.append(o)
        return np.stack(obs)

    def step_async(self, actions):
        self.actions = actions

    def step_wait(self):
        obs, rews, dones, infos = [], [], [], []
        for env, a in zip(self.envs, self.actions):
            o, r, term, trunc, info = env.step(int(a))
            done = term or trunc
            if done:
                info["terminal_observation"] = o
                o, _ = env.reset()
            obs.append(o)
            rews.append(r)
            dones.append(done)
            infos.append(info)
        return (np.stack(obs), np.asarray(rews, np.float32),
                np.asarray(dones, bool), infos)

    def get_images(self):
        return [env.render() for env in self.envs]

    def close_extras(self):
        for env in self.envs:
            env.close()


def _env_device(env):
    """The device type of the Toybox facade under an env's wrappers
    ("cuda", "cpu"), or None for an env that holds none."""
    while env is not None:
        toybox = getattr(env, "toybox", None)
        if toybox is not None:
            return toybox.device.type
        env = getattr(env, "env", None)
    return None


def _refuse_cuda_fork(env, context: str) -> None:
    """Raise for an env on cuda that forked workers would build."""
    if context == "fork" and _env_device(env) == "cuda":
        raise ValueError(
            "a forked worker cannot use CUDA: build these envs with "
            "device='cpu', or pass context='spawn' for envs on cuda")


def _subproc_worker(pipe, parent_pipe, env_fn_wrapper):
    """Worker loop: one env per process, auto-reset on done (reference
    subproc_vec_env.py:5-31). Commands arrive as (cmd, data) tuples."""
    parent_pipe.close()
    env = env_fn_wrapper()
    try:
        while True:
            cmd, data = pipe.recv()
            if cmd == "step":
                o, r, term, trunc, info = env.step(data)
                done = bool(term or trunc)
                if done:
                    info = dict(info)
                    info["terminal_observation"] = o
                    o, _ = env.reset()
                pipe.send((o, r, done, info))
            elif cmd == "reset":
                o, _ = env.reset(seed=data)
                pipe.send(o)
            elif cmd == "render":
                pipe.send(env.render())
            elif cmd == "get_spaces":
                pipe.send((env.observation_space, env.action_space))
            elif cmd == "close":
                pipe.send(None)
                break
    except KeyboardInterrupt:
        pass
    finally:
        env.close()


class SubprocVecEnv(VecEnv):
    """One OS process per env, commands over pipes: the reference's
    process-parallel executor (subproc_vec_env.py), for host-side envs.
    Toybox envs step far faster as one ``BatchedVecEnv``. context='fork'
    is the reference's platform default; with it one env is built in the
    parent first and an env on cuda is refused (a forked worker cannot
    use CUDA). Pass context='spawn' for env fns on cuda."""

    def __init__(self, env_fns, context="fork"):
        import multiprocessing as mp

        if context == "fork":
            probe = env_fns[0]()
            try:
                _refuse_cuda_fork(probe, context)
            finally:
                probe.close()
        ctx = mp.get_context(context)
        self.waiting = False
        n = len(env_fns)
        self.remotes, work_remotes = zip(*[ctx.Pipe() for _ in range(n)])
        self.procs = []
        for work_remote, remote, fn in zip(work_remotes, self.remotes,
                                           env_fns):
            p = ctx.Process(target=_subproc_worker,
                            args=(work_remote, remote,
                                  CloudpickleWrapper(fn)),
                            daemon=True)
            p.start()
            self.procs.append(p)
            work_remote.close()
        self.remotes[0].send(("get_spaces", None))
        observation_space, action_space = self.remotes[0].recv()
        super().__init__(n, observation_space, action_space)

    def reset(self, seed=None):
        for i, remote in enumerate(self.remotes):
            remote.send(("reset", None if seed is None else seed + i))
        return np.stack([remote.recv() for remote in self.remotes])

    def step_async(self, actions):
        if self.waiting:
            raise AlreadySteppingError
        for remote, a in zip(self.remotes, actions):
            remote.send(("step", int(a)))
        self.waiting = True

    def step_wait(self):
        if not self.waiting:
            raise NotSteppingError
        results = [remote.recv() for remote in self.remotes]
        self.waiting = False
        obs, rews, dones, infos = zip(*results)
        return (np.stack(obs), np.asarray(rews, np.float32),
                np.asarray(dones, bool), list(infos))

    def get_images(self):
        for remote in self.remotes:
            remote.send(("render", None))
        return [remote.recv() for remote in self.remotes]

    def close_extras(self):
        if self.waiting:
            for remote in self.remotes:
                remote.recv()
        for remote in self.remotes:
            remote.send(("close", None))
        for remote in self.remotes:
            remote.recv()
        for p in self.procs:
            p.join()


def _shmem_worker(pipe, parent_pipe, env_fn_wrapper, buf, shape, dtype):
    """Like _subproc_worker but observations are written into a shared
    buffer; the pipe carries only (reward, done, info)
    (reference shmem_vec_env.py)."""
    parent_pipe.close()
    env = env_fn_wrapper()
    arr = np.frombuffer(buf.get_obj(), dtype=dtype).reshape(shape)

    def put(o):
        arr[...] = o

    try:
        while True:
            cmd, data = pipe.recv()
            if cmd == "step":
                o, r, term, trunc, info = env.step(data)
                done = bool(term or trunc)
                if done:
                    info = dict(info)
                    info["terminal_observation"] = o
                    o, _ = env.reset()
                put(o)
                pipe.send((r, done, info))
            elif cmd == "reset":
                o, _ = env.reset(seed=data)
                put(o)
                pipe.send(None)
            elif cmd == "get_spaces":
                pipe.send((env.observation_space, env.action_space))
            elif cmd == "close":
                pipe.send(None)
                break
    except KeyboardInterrupt:
        pass
    finally:
        env.close()


class ShmemVecEnv(VecEnv):
    """Process-parallel with zero-copy observations: per-env shared
    ``multiprocessing.Array`` buffers keyed by the obs space's dtype;
    pipes carry only control (reference shmem_vec_env.py:13-43)."""

    _CTYPES = {np.dtype(np.uint8): "B", np.dtype(np.float32): "f",
               np.dtype(np.float64): "d", np.dtype(np.int32): "i",
               np.dtype(np.int64): "l", np.dtype(bool): "B"}

    def __init__(self, env_fns, context="fork"):
        import multiprocessing as mp

        ctx = mp.get_context(context)
        # probe spaces once in-parent (reference keeps a dummy env for it)
        probe = env_fns[0]()
        observation_space = probe.observation_space
        action_space = probe.action_space
        try:
            _refuse_cuda_fork(probe, context)
        finally:
            probe.close()
        shape = observation_space.shape
        dtype = np.dtype(observation_space.dtype)
        n = len(env_fns)
        super().__init__(n, observation_space, action_space)

        self.obs_bufs = [
            ctx.Array(self._CTYPES[dtype], int(np.prod(shape)))
            for _ in range(n)]
        self._obs_views = [
            np.frombuffer(b.get_obj(), dtype=dtype).reshape(shape)
            for b in self.obs_bufs]
        self.waiting = False
        self.remotes, work_remotes = zip(*[ctx.Pipe() for _ in range(n)])
        self.procs = []
        for work_remote, remote, fn, buf in zip(
                work_remotes, self.remotes, env_fns, self.obs_bufs):
            p = ctx.Process(target=_shmem_worker,
                            args=(work_remote, remote,
                                  CloudpickleWrapper(fn), buf, shape,
                                  dtype),
                            daemon=True)
            p.start()
            self.procs.append(p)
            work_remote.close()

    def _gather_obs(self):
        return np.stack([v.copy() for v in self._obs_views])

    def reset(self, seed=None):
        for i, remote in enumerate(self.remotes):
            remote.send(("reset", None if seed is None else seed + i))
        for remote in self.remotes:
            remote.recv()
        return self._gather_obs()

    def step_async(self, actions):
        if self.waiting:
            raise AlreadySteppingError
        for remote, a in zip(self.remotes, actions):
            remote.send(("step", int(a)))
        self.waiting = True

    def step_wait(self):
        if not self.waiting:
            raise NotSteppingError
        results = [remote.recv() for remote in self.remotes]
        self.waiting = False
        rews, dones, infos = zip(*results)
        return (self._gather_obs(), np.asarray(rews, np.float32),
                np.asarray(dones, bool), list(infos))

    def close_extras(self):
        if self.waiting:
            for remote in self.remotes:
                remote.recv()
        for remote in self.remotes:
            remote.send(("close", None))
        for remote in self.remotes:
            remote.recv()
        for p in self.procs:
            p.join()


class BatchedVecEnv(VecEnv):
    """The batched env (every env stepped at once on ``device``; no worker
    processes, no pipes) behind the VecEnv interface, with numpy
    observations, rewards, dones and infos."""

    def __init__(self, game_name, num_envs, obs_mode="grayscale", seed=0,
                 config=None, device="cuda"):
        from gymnasium import spaces

        from toybox_tpu_torch.envs.batched import BatchedEnv
        self._env = BatchedEnv(game_name, num_envs, config=config,
                               obs_mode=obs_mode, seed=seed, device=device)
        obs_shape = self._env.fns.obs_shape
        super().__init__(
            num_envs,
            spaces.Box(low=0, high=255, shape=obs_shape, dtype=np.uint8),
            spaces.Discrete(self._env.num_actions))
        self.actions = None

    def reset(self, seed=None):
        return self._env.reset(seed=seed).cpu().numpy()

    def step_async(self, actions):
        self.actions = actions

    def step_wait(self):
        obs, rew, done, info = self._env.step(
            torch.as_tensor(np.asarray(self.actions)))
        info = {k: v.cpu().numpy() for k, v in info.items()}
        infos = [{k: v[i] for k, v in info.items()}
                 for i in range(self.num_envs)]
        return (obs.cpu().numpy(), rew.cpu().numpy(), done.cpu().numpy(),
                infos)


def make_vec_env(env_id, num_env=1, seed=None, sample_weights=None,
                 monitor_path=None, use_batched=True, start_index=0,
                 device="cuda"):
    """Env factory (reference common/cmd_util.py:22-42 make_vec_env): a
    monitored vectorized env of the port's envs on ``device``. The
    default executor is BatchedVecEnv; use_batched=False builds
    DummyVecEnv over gymnasium envs (required for SampleEnvs Toybox/ALE
    mixing, which is per-process)."""
    from toybox_tpu_torch.regress import env_id_to_game

    if use_batched and not sample_weights:
        venv = BatchedVecEnv(env_id_to_game(env_id.rsplit("/", 1)[-1]),
                             num_env, seed=seed or 0, device=device)
    else:
        from toybox_tpu_torch.envs.wrappers import make_atari

        def thunk(rank):
            def _make():
                env = make_atari(env_id, sample_weights=sample_weights,
                                 device=device)
                if seed is not None:
                    env.reset(seed=seed + start_index + rank)
                return env
            return _make

        venv = DummyVecEnv([thunk(i) for i in range(num_env)])
    if monitor_path:
        venv = VecMonitor(venv, filename=monitor_path)
    return venv


class VecFrameStack(VecEnvWrapper):
    """Stack the last k observations along the channel axis
    (reference vec_frame_stack.py)."""

    def __init__(self, venv, nstack):
        self.nstack = nstack
        wos = venv.observation_space
        low = np.repeat(wos.low, nstack, axis=-1)
        high = np.repeat(wos.high, nstack, axis=-1)
        self.stackedobs = np.zeros((venv.num_envs,) + low.shape, low.dtype)
        from gymnasium import spaces
        observation_space = spaces.Box(low=low, high=high, dtype=wos.dtype)
        super().__init__(venv, observation_space=observation_space)

    def step_wait(self):
        obs, rews, news, infos = self.venv.step_wait()
        self.stackedobs = np.roll(self.stackedobs, shift=-obs.shape[-1],
                                  axis=-1)
        for i, new in enumerate(news):
            if new:
                self.stackedobs[i] = 0
        self.stackedobs[..., -obs.shape[-1]:] = obs
        return self.stackedobs.copy(), rews, news, infos

    def reset(self, **kwargs):
        obs = self.venv.reset(**kwargs)
        self.stackedobs[...] = 0
        self.stackedobs[..., -obs.shape[-1]:] = obs
        return self.stackedobs.copy()


class RunningMeanStd:
    """Parallel-variance running moments
    (reference common/running_mean_std.py)."""

    def __init__(self, epsilon=1e-4, shape=()):
        self.mean = np.zeros(shape, np.float64)
        self.var = np.ones(shape, np.float64)
        self.count = epsilon

    def update(self, x):
        batch_mean = x.mean(axis=0)
        batch_var = x.var(axis=0)
        batch_count = x.shape[0]
        delta = batch_mean - self.mean
        tot = self.count + batch_count
        new_mean = self.mean + delta * batch_count / tot
        m_a = self.var * self.count
        m_b = batch_var * batch_count
        m2 = m_a + m_b + np.square(delta) * self.count * batch_count / tot
        self.mean, self.var, self.count = new_mean, m2 / tot, tot


class VecNormalize(VecEnvWrapper):
    """Running-mean-std obs/return normalization
    (reference vec_normalize.py)."""

    def __init__(self, venv, ob=True, ret=True, clipob=10., cliprew=10.,
                 gamma=0.99, epsilon=1e-8):
        super().__init__(venv)
        self.ob_rms = RunningMeanStd(
            shape=self.observation_space.shape) if ob else None
        self.ret_rms = RunningMeanStd(shape=()) if ret else None
        self.clipob = clipob
        self.cliprew = cliprew
        self.ret = np.zeros(self.num_envs)
        self.gamma = gamma
        self.epsilon = epsilon

    def step_wait(self):
        obs, rews, news, infos = self.venv.step_wait()
        self.ret = self.ret * self.gamma + rews
        obs = self._obfilt(obs)
        if self.ret_rms:
            self.ret_rms.update(self.ret)
            rews = np.clip(rews / np.sqrt(self.ret_rms.var + self.epsilon),
                           -self.cliprew, self.cliprew)
        self.ret[news] = 0.
        return obs, rews, news, infos

    def _obfilt(self, obs):
        if self.ob_rms:
            self.ob_rms.update(obs)
            obs = np.clip(
                (obs - self.ob_rms.mean)
                / np.sqrt(self.ob_rms.var + self.epsilon),
                -self.clipob, self.clipob)
        return obs

    def reset(self, **kwargs):
        self.ret = np.zeros(self.num_envs)
        return self._obfilt(self.venv.reset(**kwargs))


class VecMonitor(VecEnvWrapper):
    """Per-episode reward/length bookkeeping into infos['episode']
    (reference vec_monitor.py)."""

    def __init__(self, venv, filename=None):
        super().__init__(venv)
        self.eprets = np.zeros(self.num_envs)
        self.eplens = np.zeros(self.num_envs, int)
        self.tstart = time.time()
        self.results_writer = None
        if filename:
            from toybox_tpu_torch.utils.monitor import BatchedMonitor
            self.results_writer = BatchedMonitor(filename)

    def reset(self, **kwargs):
        obs = self.venv.reset(**kwargs)
        self.eprets[:] = 0
        self.eplens[:] = 0
        return obs

    def step_wait(self):
        obs, rews, dones, infos = self.venv.step_wait()
        self.eprets += rews
        self.eplens += 1
        newinfos = list(infos)
        for i, done in enumerate(dones):
            if done:
                epinfo = {"r": round(float(self.eprets[i]), 6),
                          "l": int(self.eplens[i]),
                          "t": round(time.time() - self.tstart, 6)}
                info = dict(newinfos[i])
                info["episode"] = epinfo
                newinfos[i] = info
                if self.results_writer:
                    self.results_writer.writer.writerow(epinfo)
                    self.results_writer.f.flush()
                self.eprets[i] = 0
                self.eplens[i] = 0
        return obs, rews, dones, newinfos
