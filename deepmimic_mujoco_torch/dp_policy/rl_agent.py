"""The original stack's act-and-train driver (port of
``deepmimic_mujoco_tpu/dp_policy/rl_agent.py``) over a batched env.

* per step and env an ε-coin at the annealed rate; exploring actions carry
  ``EXP_ACTION_FLAG`` and Gaussian noise;
* paths enter the replay buffer when they END, n + 1 records each, in the
  (step, env) order of their ends; a path's end record keeps its terminal
  state (the next obs before the auto-reset), labelled SUCC where a
  non-looping clip is over, NULL at the step cap and FAIL otherwise;
* training fires once the buffer holds more than BatchSize records and
  one exploring record, checked after every rollout chunk; it consumes the
  whole buffer, then clears it;
* TEST mode runs the deterministic policy.

The rollout runs on the env's device; path assembly and the ring live on
the host, as in the original.  Every random draw goes through
:class:`~deepmimic_mujoco_torch.dp_policy.draws.Draws`.  JAX's multi-host
episode accounting is not ported (ROADMAP.md, queue A, item 8)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deepmimic_mujoco_torch.dp_policy.draws import Draws
from deepmimic_mujoco_torch.dp_policy.path import Path, Terminate
from deepmimic_mujoco_torch.dp_policy.ppo_agent import PPOAgent
from deepmimic_mujoco_torch.dp_policy.replay_buffer import ReplayBuffer


class Mode:
    TRAIN = 0
    TEST = 1
    TRAIN_END = 2


class RLAgentDriver:
    def __init__(self, env, agent: PPOAgent, num_envs: int = 32,
                 seed: int = 0, chunk: int = 32,
                 draws: Optional[Draws] = None):
        self.env = env
        self.agent = agent
        self.num_envs = num_envs
        self.chunk = chunk
        self.mode = Mode.TRAIN
        self.device = env.device
        self.draws = draws if draws is not None else Draws(
            torch.Generator(device=self.device).manual_seed(seed))
        self.replay_buffer = ReplayBuffer(
            int(agent.spec.get("ReplayBufferSize", 500000)))
        # per env, the pieces of its unfinished path: (states, actions,
        # logps, rewards, flags) arrays of the chunks it spans
        self._pending: list[list[tuple]] = [[] for _ in range(num_envs)]
        self._path_returns: list[float] = []
        self.iter = 0
        # the per-episode returns and lengths of the last test_episodes
        self.test_returns: Optional[torch.Tensor] = None
        self.test_lengths: Optional[torch.Tensor] = None
        # the train step's pad size, JAX's static cap: training fires on
        # the first chunk that pushes the buffer past BatchSize, and a
        # chunk adds at most num_envs·chunk step records plus one end
        # record per done
        cap = agent.batch_size + 2 * num_envs * chunk + 64
        self._train_cap = int(-(-cap // 256) * 256)
        self._n_mb = max(1, -(-agent.batch_size // agent.mini_batch_size))

    # ------------------------------------------------------------------
    def _rollout(self, params: dict, env_state):
        """One chunk of acting: ε-coins, action noise, the env step, the
        terminate labels and the auto-reset of the done envs.  Returns the
        next env state and the chunk (obs, actions, logps, rewards, dones,
        exploring, terminates, next obs before the reset), each with
        leading (chunk, B) axes, on the device."""
        env, agent = self.env, self.agent
        B, T = self.num_envs, self.chunk
        cap = getattr(env, "max_episode_steps", 0)
        wraps = getattr(env, "clip_wraps", True)
        clip_len = getattr(env, "clip_len", 0)
        # a noise reset where the env has one (DPEnvV3), RSI otherwise
        reset_fn = getattr(env, "reset_init", env.reset)
        dev = self.device
        no = torch.zeros(B, dtype=torch.bool, device=dev)
        with torch.no_grad():
            rate, _ = agent.exp_params_at(params["sample_count"])
            coins, noise = self.draws.rollout_chunk(T, B, agent.action_size,
                                                    dev)
            out = []
            for t in range(T):
                ob = env_state.obs
                exploring = coins[t] < rate
                a, logp = agent.decide_action(params, ob, exploring, noise[t])
                nxt = env.step(env_state, a)
                done = nxt.done
                cap_done = nxt.step_count >= cap if cap else no
                if wraps or not clip_len:
                    succ = no
                elif hasattr(env, "_clip_over"):
                    # the env's own scaled cursor: a clip of 60 fps ends at
                    # a raw cursor of about half its frames
                    succ = env._clip_over(nxt.mocap_idx, nxt.init_idx)
                else:
                    succ = nxt.mocap_idx >= clip_len - 1
                term = torch.where(
                    done & succ, Terminate.SUCC,
                    torch.where(done & ~cap_done, Terminate.FAIL,
                                Terminate.NULL)).to(torch.int8)
                fresh = self.draws.fresh_states(reset_fn, done)
                env_state = fresh.where(done, nxt)
                out.append((ob, a, logp, nxt.reward, done, exploring, term,
                            nxt.obs))
        return env_state, tuple(torch.stack(x) for x in zip(*out))

    def _absorb_chunk(self, traj) -> None:
        """Append a rolled chunk to the per-env pending paths and store
        each path that ended, in the (step, env) order of the ends."""
        obs, acs, logps, rews, dones, exps, terms, obs_next = (
            x.cpu().numpy() for x in traj)
        T, B = rews.shape
        rews = rews.astype(np.float64)  # the return sums floats, as JAX's
        flags = np.where(exps, PPOAgent.EXP_ACTION_FLAG, 0).astype(np.int32)
        cols = (obs, acs, logps, rews, flags)
        start = np.zeros(B, np.int64)
        for t, b in np.argwhere(dones):
            pieces = self._pending[b] + [
                tuple(c[start[b]:t + 1, b] for c in cols)]
            path = Path()
            path.states = np.concatenate([p[0] for p in pieces]
                                         + [obs_next[t, b][None]])
            (path.actions, path.logps, path.rewards, path.flags) = (
                np.concatenate([p[k] for p in pieces]) for k in range(1, 5))
            path.terminate = int(terms[t, b])
            self._path_returns.append(path.calc_return())
            self.replay_buffer.store(path)
            self._pending[b] = []
            start[b] = t + 1
        for b in range(B):
            if start[b] < T:
                self._pending[b].append(tuple(c[start[b]:, b].copy()
                                              for c in cols))

    def _valid_train_step(self) -> bool:
        return (self.replay_buffer.get_current_size() > self.agent.batch_size
                and self.replay_buffer.count_filtered(
                    PPOAgent.EXP_ACTION_FLAG) > 0)

    def _train(self, params: dict):
        """The train step over the whole buffer, padded to the static cap
        (padding is end records, left out by ``valid``), then clear."""
        buf = self.replay_buffer
        n = buf.get_current_size()
        cap = self._train_cap
        if n > cap:  # unreachable by construction; never truncate silently
            raise RuntimeError(
                f"replay buffer holds {n} records > static pad cap {cap}")

        def pad(a, fill=0.0):
            out = np.full((cap,) + a.shape[1:], fill, a.dtype)
            out[:n] = a
            return torch.as_tensor(out).to(self.device)

        flag = PPOAgent.EXP_ACTION_FLAG
        params, metrics = self.agent.train_on_batch(
            params, self.draws, pad(buf.get_all("states")),
            pad(buf.get_all("actions")), pad(buf.get_all("logps")),
            pad(buf.get_all("rewards")), pad(buf.end_mask(), True),
            pad(buf.fail_mask(), False), pad(buf.succ_mask(), False),
            pad(buf.flag_mask(flag), False), self._n_mb,
            valid=pad(np.ones(n, bool), False))
        buf.clear()
        self.iter += 1
        return params, metrics

    # ------------------------------------------------------------------
    def train_iteration(self, params: dict, env_state):
        """Roll chunks until a train step may fire, then train on the
        buffer and clear it.  Returns (params, env_state, metrics), the
        metrics as floats with ``avg_path_reward`` over the paths stored
        since the last call."""
        while not self._valid_train_step():
            env_state, traj = self._rollout(params, env_state)
            self._absorb_chunk(traj)
        params, metrics = self._train(params)
        metrics = {k: float(v) for k, v in metrics.items()}
        if self._path_returns:
            metrics["avg_path_reward"] = float(np.mean(self._path_returns))
            self._path_returns.clear()
        return params, env_state, metrics

    def test_episodes(self, params: dict, n_episodes: int = 32,
                      horizon: int = 512) -> tuple[float, float]:
        """TEST mode: ``n_episodes`` episodes of the deterministic policy
        from fresh starts, at most ``horizon`` steps each; returns (average
        return, average length).  A finished episode's state is frozen and
        its return and length stop; the loop ends once every episode has
        ended (JAX scans the whole horizon with the same result).  The
        per-episode returns and lengths stay in ``test_returns`` and
        ``test_lengths``."""
        env, agent = self.env, self.agent
        state = self.draws.test_starts(env.reset, n_episodes)
        alive = torch.ones(n_episodes, dtype=torch.bool, device=self.device)
        ret = torch.zeros(n_episodes, device=self.device)
        length = torch.zeros(n_episodes, dtype=torch.int64,
                             device=self.device)
        with torch.no_grad():
            for _ in range(horizon):
                nxt = env.step(state, agent.get_action(params, state.obs))
                ret = ret + torch.where(alive, nxt.reward, 0.0)
                length = length + alive.to(torch.int64)
                state = nxt.where(alive, state)
                alive = alive & ~nxt.done
                if not bool(alive.any()):
                    break
        self.test_returns, self.test_lengths = ret, length
        return (float(torch.sum(ret)) / n_episodes,
                float(torch.sum(length)) / n_episodes)
