"""RL trainers on the task pool (port of ``orca/rl.py``): the RayOnSpark +
RLlib workload.

Rollout workers are ``TaskPool`` tasks running a numpy policy (the env,
the MLP's init and forward and ``collect_rollouts`` are the JAX module's
numpy, copied), and :class:`PPOTrainer` exposes the RLlib-style
``trainer.train() -> result`` loop whose clipped-surrogate PPO update runs
in torch on the trainer's device, with the port's optax-shaped Adam.

    trainer = PPOTrainer(env_fn=CatchEnv, config={"num_workers": 4})
    for _ in range(20):
        result = trainer.train()
        print(result["episode_reward_mean"])
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

DEFAULT_CONFIG: Dict[str, Any] = {
    "num_workers": 2,            # rollout worker processes
    "episodes_per_worker": 16,   # per train() round
    "gamma": 0.99,
    "lr": 3e-3,
    "clip_param": 0.2,           # PPO clipped-surrogate epsilon
    "num_sgd_iter": 4,
    "hidden": 64,
    "entropy_coeff": 0.01,
    "seed": 0,
}


class CatchEnv:
    """Minimal gym-like env: a ball falls down an H×W grid; the bottom
    paddle moves left/stay/right; +1 for a catch, -1 for a miss. Episodes
    are H-1 steps."""

    H, W = 8, 8
    n_actions = 3

    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)

    @property
    def obs_dim(self) -> int:
        return self.H * self.W

    def reset(self) -> np.ndarray:
        self.ball = [0, int(self.rng.integers(0, self.W))]
        self.paddle = self.W // 2
        return self._obs()

    def _obs(self) -> np.ndarray:
        board = np.zeros((self.H, self.W), dtype="float32")
        board[self.ball[0], self.ball[1]] = 1.0
        board[self.H - 1, self.paddle] = -1.0
        return board.ravel()

    def step(self, action: int):
        self.paddle = int(np.clip(self.paddle + (action - 1), 0, self.W - 1))
        self.ball[0] += 1
        done = self.ball[0] == self.H - 1
        reward = (1.0 if self.ball[1] == self.paddle else -1.0) if done else 0.0
        return self._obs(), reward, done, {}


def _mlp_init(obs_dim: int, hidden: int, n_actions: int, seed: int):
    rng = np.random.default_rng(seed)
    s1 = np.sqrt(2.0 / obs_dim)
    s2 = np.sqrt(2.0 / hidden)
    return {
        "w1": (rng.standard_normal((obs_dim, hidden)) * s1).astype("float32"),
        "b1": np.zeros(hidden, "float32"),
        "w2": (rng.standard_normal((hidden, n_actions)) * s2).astype("float32"),
        "b2": np.zeros(n_actions, "float32"),
        "vw": (rng.standard_normal((hidden, 1)) * s2).astype("float32"),
        "vb": np.zeros(1, "float32"),
    }


def _np_forward(w, obs):
    """Numpy policy+value forward for the rollout workers."""
    h = np.tanh(obs @ w["w1"] + w["b1"])
    logits = h @ w["w2"] + w["b2"]
    z = np.exp(logits - logits.max(axis=-1, keepdims=True))
    probs = z / z.sum(axis=-1, keepdims=True)
    value = (h @ w["vw"] + w["vb"])[..., 0]
    return probs, value


def collect_rollouts(weights, env_fn, n_episodes: int, gamma: float,
                     seed: int):
    """Task body: play episodes, return (obs, act, logp, returns, adv, rew)."""
    obs_l: List[np.ndarray] = []
    act_l: List[int] = []
    logp_l: List[float] = []
    ret_l: List[float] = []
    adv_l: List[float] = []
    ep_rewards: List[float] = []
    for k in range(n_episodes):
        env = env_fn(seed * 100_003 + k)
        rng = np.random.default_rng(seed * 7919 + k)
        obs = env.reset()
        ep_obs, ep_act, ep_logp, ep_val, ep_rew = [], [], [], [], []
        while True:
            probs, value = _np_forward(weights, obs[None, :])
            a = int(rng.choice(len(probs[0]), p=probs[0]))
            ep_obs.append(obs)
            ep_act.append(a)
            ep_logp.append(float(np.log(probs[0, a] + 1e-9)))
            ep_val.append(float(value[0]))
            obs, r, done, _ = env.step(a)
            ep_rew.append(float(r))
            if done:
                break
        # discounted returns + advantages vs the value baseline
        ret, g = [], 0.0
        for r in reversed(ep_rew):
            g = r + gamma * g
            ret.append(g)
        ret.reverse()
        obs_l.extend(ep_obs)
        act_l.extend(ep_act)
        logp_l.extend(ep_logp)
        ret_l.extend(ret)
        adv_l.extend(np.asarray(ret) - np.asarray(ep_val))
        ep_rewards.append(sum(ep_rew))
    return (np.asarray(obs_l, "float32"), np.asarray(act_l, "int32"),
            np.asarray(logp_l, "float32"), np.asarray(ret_l, "float32"),
            np.asarray(adv_l, "float32"), float(np.mean(ep_rewards)))


class PPOTrainer:
    """RLlib-style trainer: ``train()`` runs one round of parallel rollouts
    and clipped-surrogate PPO epochs and returns a result dict.

    ``pool``: any object whose ``submit`` returns futures with
    ``result(timeout=)`` (a ``TaskPool``, a ``ThreadPoolExecutor``); a
    ``TaskPool`` of ``num_workers`` is made at the first ``train()``
    otherwise. The update runs on ``device`` (CUDA unless given)."""

    def __init__(self, env_fn: Callable[[int], Any] = CatchEnv,
                 config: Optional[Dict[str, Any]] = None, pool=None, *,
                 device=None):
        from ..nn.module import resolve_device
        from ..nn.optimizers import Adam

        self.config = {**DEFAULT_CONFIG, **(config or {})}
        self.env_fn = env_fn
        self.device = resolve_device(device)
        probe = env_fn(0)
        self.weights = _mlp_init(probe.obs_dim, self.config["hidden"],
                                 probe.n_actions, self.config["seed"])
        self._pool = pool
        self._owns_pool = pool is None
        self.iteration = 0
        self._opt = Adam(lr=self.config["lr"])
        self._opt_state = self._opt.init(self._on_device(self.weights))

    def _on_device(self, arrays: Dict[str, np.ndarray]):
        return {k: torch.from_numpy(np.array(v)).to(self.device)
                for k, v in arrays.items()}

    # -- loss (torch, on the trainer's device) -------------------------------
    def _ppo_loss(self, w, obs, act, logp_old, ret, adv):
        h = torch.tanh(obs @ w["w1"] + w["b1"])
        logits = h @ w["w2"] + w["b2"]
        logp_all = torch.log_softmax(logits, dim=-1)
        logp = logp_all.gather(1, act[:, None])[:, 0]
        ratio = torch.exp(logp - logp_old)
        eps = self.config["clip_param"]
        surr = torch.minimum(ratio * adv,
                             torch.clamp(ratio, 1 - eps, 1 + eps) * adv)
        value = (h @ w["vw"] + w["vb"])[:, 0]
        v_loss = torch.mean((value - ret) ** 2)
        entropy = -torch.mean(torch.sum(torch.exp(logp_all) * logp_all,
                                        dim=-1))
        return (-torch.mean(surr) + 0.5 * v_loss
                - self.config["entropy_coeff"] * entropy)

    def _update(self, obs, act, logp, ret, adv) -> None:
        """``num_sgd_iter`` Adam steps of the PPO loss on the device."""
        from ..nn.optimizers import apply_updates

        batch = self._on_device({"obs": obs, "logp": logp, "ret": ret,
                                 "adv": adv})
        act_t = torch.from_numpy(act.astype(np.int64)).to(self.device)
        w = self._on_device(self.weights)
        for _ in range(self.config["num_sgd_iter"]):
            leaves = {k: v.requires_grad_() for k, v in w.items()}
            loss = self._ppo_loss(leaves, batch["obs"], act_t, batch["logp"],
                                  batch["ret"], batch["adv"])
            grads = dict(zip(leaves, torch.autograd.grad(
                loss, list(leaves.values()))))
            with torch.no_grad():
                updates, self._opt_state = self._opt.update(
                    grads, self._opt_state, w)
                w = apply_updates({k: v.detach() for k, v in w.items()},
                                  updates)
        self.weights = {k: v.cpu().numpy() for k, v in w.items()}

    # -- public API ----------------------------------------------------------
    def train(self) -> Dict[str, Any]:
        from .task_pool import TaskPool

        cfg = self.config
        if self._pool is None:
            self._pool = TaskPool(cfg["num_workers"])
        futs = [self._pool.submit(collect_rollouts, self.weights, self.env_fn,
                                  cfg["episodes_per_worker"], cfg["gamma"],
                                  cfg["seed"] * 1000 + self.iteration * 17
                                  + wid)
                for wid in range(cfg["num_workers"])]
        parts = [f.result(timeout=600) for f in futs]
        obs = np.concatenate([p[0] for p in parts])
        act = np.concatenate([p[1] for p in parts])
        logp = np.concatenate([p[2] for p in parts])
        ret = np.concatenate([p[3] for p in parts])
        adv = np.concatenate([p[4] for p in parts])
        adv = (adv - adv.mean()) / (adv.std() + 1e-6)
        reward_mean = float(np.mean([p[5] for p in parts]))
        self._update(obs, act, logp, ret, adv)
        self.iteration += 1
        return {
            "training_iteration": self.iteration,
            "episode_reward_mean": reward_mean,
            "episodes_this_iter": cfg["num_workers"] * cfg["episodes_per_worker"],
            "timesteps_this_iter": int(len(obs)),
        }

    def get_weights(self):
        return dict(self.weights)

    def set_weights(self, weights):
        """Weight sync between trainers (the multiagent_two_trainers
        periodic-sync pattern)."""
        self.weights = {k: np.asarray(v) for k, v in weights.items()}

    def stop(self):
        if self._pool is not None and self._owns_pool:
            self._pool.shutdown()
        self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


__all__ = ["CatchEnv", "DEFAULT_CONFIG", "PPOTrainer", "collect_rollouts"]
