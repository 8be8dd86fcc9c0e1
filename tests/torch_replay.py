"""JAX's random draws fed to the port through its seams, ``trpo.Draws``
(shared by ``test_torch_gail.py`` and ``test_torch_ppo.py``) and
``dp_policy.draws.Draws`` (``test_torch_dp_policy.py``).

The two stacks cannot share random streams (JAX threefry, torch Philox),
so the port's draws are replaced by the draws JAX makes from the same keys
in the same split order: the rollout's action noise and post-done resets
(``deepmimic_mujoco_tpu/algos/trpo.py:_rollout``, the same in GAIL's and
PPO's rollouts), the vf and PPO epoch permutations, and GAIL's d-step
permutation or legacy subsamples (``algos/gail.py:iteration``); for the
original-stack driver (``deepmimic_mujoco_tpu/dp_policy/rl_agent.py``) the
chunk's ε-coins and action noise, the auto-resets, the test starts and the
train step's minibatch indices, in the driver key's split order."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from deepmimic_mujoco_tpu.algos.trpo import pick_reset_fn
from deepmimic_mujoco_torch.algos import trpo
from deepmimic_mujoco_torch.dp_policy import draws as dp_draws


def _t(x):
    return torch.as_tensor(np.asarray(x))


def port_env_state(js) -> trpo.EnvState:
    """A JAX single-clip ``EnvState`` as the port's."""
    return trpo.EnvState(
        qpos=_t(js.qpos), qvel=_t(js.qvel), obs=_t(js.obs),
        reward=_t(js.reward), done=_t(js.done),
        mocap_idx=_t(js.mocap_idx).long(), init_idx=_t(js.init_idx).long(),
        step_count=_t(js.step_count).long())


def fresh_fn(env, reset_mode: str):
    """JAX's post-done reset of every env from its key, jitted."""
    reset = pick_reset_fn(env, reset_mode)
    return jax.jit(jax.vmap(lambda k: reset(jax.random.split(k)[0])))


class ReplayDraws(trpo.Draws):
    """``key``: the JAX state's PRNG key; ``env_keys``: its envs' keys
    (B, 2); ``fresh``: :func:`fresh_fn` of the JAX env."""

    def __init__(self, key, env_keys=None, fresh=None):
        super().__init__(None)
        self.key, self.env_keys, self._fresh = key, env_keys, fresh

    def _split(self):
        self.key, k = jax.random.split(self.key)
        return k

    def action_noise(self, mean):
        k_acts = jax.random.split(self._split(), mean.shape[0])
        return _t(jax.vmap(lambda k: jax.random.normal(
            k, (mean.shape[1],), jnp.float32))(k_acts))

    def fresh_states(self, reset_fn, done, state=None):
        fresh = self._fresh(self.env_keys)
        self.env_keys = jnp.where(jnp.asarray(done.numpy())[:, None],
                                  fresh.key, self.env_keys)
        return port_env_state(fresh)

    def vf_permutations(self, n, epochs, device):
        return torch.stack([_t(jax.random.permutation(k, n)).long()
                            for k in jax.random.split(self._split(), epochs)])

    def d_permutation(self, n, device):
        return _t(jax.random.permutation(self._split(), n)).long()

    def d_subsamples(self, n, n_exp, n_mb, mb, device):
        ks = jax.random.split(self._split(), 2 * n_mb)
        g_idx = jax.vmap(lambda k: jax.random.choice(
            k, n, (mb,), replace=False))(ks[:n_mb])
        e_idx = jax.vmap(lambda k: jax.random.choice(
            k, n_exp, (mb,), replace=True))(ks[n_mb:])
        return _t(g_idx).long(), _t(e_idx).long()


class AgentReplayDraws(dp_draws.Draws):
    """The draws JAX's ``PPOAgent.train_on_batch`` or ``update`` makes from
    ``key``, the key it was handed."""

    def __init__(self, key):
        super().__init__(None)
        self.key = key

    def _split(self):
        return self.key

    def minibatch_indices(self, p_critic, p_actor, epochs, n_mb, size):
        pc, pa = (jnp.asarray(p.numpy()) for p in (p_critic, p_actor))
        n = pc.shape[0]
        c_idx, a_idx = [], []
        for k_ep in jax.random.split(self._split(), epochs):
            for k_mb in jax.random.split(k_ep, n_mb):
                k_c, k_a = jax.random.split(k_mb)
                c_idx.append(jax.random.choice(k_c, n, (size,), p=pc))
                a_idx.append(jax.random.choice(k_a, n, (size,), p=pa))
        return _t(np.stack(c_idx)).long(), _t(np.stack(a_idx)).long()

    def epoch_permutations(self, n, epochs, device):
        return torch.stack([_t(jax.random.permutation(k, n)).long()
                            for k in jax.random.split(self._split(), epochs)])


class DriverReplayDraws(AgentReplayDraws):
    """The draws of JAX's ``RLAgentDriver`` from its key ``key`` (split at
    each chunk, train step and test) and its envs' keys ``env_keys`` (B, 2):
    the auto-resets and test starts are JAX's frames, which ``tenv`` (the
    port's env) resets to."""

    def __init__(self, key, env_keys, jenv, tenv):
        super().__init__(key)
        self.env_keys, self.tenv = env_keys, tenv
        self._fresh = jax.jit(jax.vmap(
            lambda k: jenv.reset(jax.random.split(k)[0])))
        self._starts = jax.jit(jax.vmap(jenv.reset))

    def _split(self):
        self.key, k = jax.random.split(self.key)
        return k

    def rollout_chunk(self, steps, n_envs, action_size, device):
        key, coins, noise = self._split(), [], []
        for _ in range(steps):
            key, k_act, k_coin = jax.random.split(key, 3)
            coins.append(jax.random.uniform(k_coin, (n_envs,)))
            noise.append(jax.vmap(lambda k: jax.random.normal(
                k, (action_size,), jnp.float32))(
                    jax.random.split(k_act, n_envs)))
        return _t(np.stack(coins)), _t(np.stack(noise))

    def fresh_states(self, reset_fn, done):
        fresh = self._fresh(self.env_keys)
        self.env_keys = jnp.where(jnp.asarray(done.numpy())[:, None],
                                  fresh.key, self.env_keys)
        return self.tenv.reset_at(np.asarray(fresh.init_idx))

    def test_starts(self, reset_fn, n):
        st = self._starts(jax.random.split(self._split(), n))
        return self.tenv.reset_at(np.asarray(st.init_idx))
