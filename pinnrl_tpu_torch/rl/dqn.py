"""DQN agent for RL-driven collocation sampling.

The port of ``pinnrl_tpu.rl.dqn``. The replay buffer, the TD update, the
target sync and the epsilon-greedy choice run on the agent's device:

- ``RLAgentState`` holds the policy and target parameter dicts, the Adam
  state, the ring buffers, and ``ptr``, ``size``, ``steps``, ``epsilon`` and
  ``episode_reward`` as device tensors, each updated in place (as JAX's
  device-side state), so that a replayed CUDA graph of the trainer's step
  advances them: the push writes at the device ``ptr``, the target sync is
  a ``torch.where`` on the device ``steps`` (JAX's ``jnp.where``) and the
  replay draw takes its bound from the device ``size``. JAX's ``lax.cond``
  on ``size >= batch_size`` is decided on the host from ``filled``, the
  transitions the host has seen pushed, counted up to ``min(batch_size,
  memory_size)``: ``size`` never falls, so once ``settled`` the branch
  never changes (the trainer and the sampling harness replay a captured
  step only then).
- ``select_action`` scores the candidate points with the ``fused_mlp_score``
  kernel on every call and picks Q or uniform random scores with
  ``torch.where`` on a device-side Bernoulli draw, exploring or not.
- Methods update the state in place and return it (the JAX agent returns a
  new one).

Every draw comes from an explicit ``torch.Generator``; the deterministic
part of each method takes its draws as tensors (``_select``, ``_train_on``),
so the tests feed both packages the same numbers.

``save_state`` / ``load_state`` keep a state in an ``.npz``: the policy
and target weights by flax path (``models/bridge.py``), the Adam moments
and step counts, the replay buffer, epsilon, the episode reward and the
counters. ``state_arrays`` / ``load_arrays`` give and take the same
arrays in memory (a trainer's checkpoint holds them).

``CollocationAgent`` is the lighter scorer without replay or target
network.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pinnrl_tpu_torch.config import resolve_device
from pinnrl_tpu_torch.ops.kernels import mlp
from pinnrl_tpu_torch.training.trainer import AdamStep

_LN_EPS = 1e-6  # flax.linen.LayerNorm default


def _xavier_dense(in_dim: int, out_dim: int, generator: torch.Generator) -> nn.Linear:
    """``nn.Linear`` with flax's ``xavier_uniform`` kernel init and zero bias."""
    layer = nn.Linear(in_dim, out_dim)
    with torch.no_grad():
        nn.init.xavier_uniform_(layer.weight, generator=generator)
        layer.bias.zero_()
    return layer


class DQNNetwork(nn.Module):
    """Dense -> LayerNorm -> ReLU (x2) -> Dense(action_dim)."""

    def __init__(self, state_dim: int = 2, action_dim: int = 1, hidden_dim: int = 512,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.Dense_0 = _xavier_dense(state_dim, hidden_dim, gen)
        self.LayerNorm_0 = nn.LayerNorm(hidden_dim, eps=_LN_EPS)
        self.Dense_1 = _xavier_dense(hidden_dim, hidden_dim, gen)
        self.LayerNorm_1 = nn.LayerNorm(hidden_dim, eps=_LN_EPS)
        self.Dense_2 = _xavier_dense(hidden_dim, action_dim, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.LayerNorm_0(self.Dense_0(x)))
        x = torch.relu(self.LayerNorm_1(self.Dense_1(x)))
        return self.Dense_2(x)


@dataclass
class RLAgentState:
    policy_params: Dict[str, torch.Tensor]
    target_params: Dict[str, torch.Tensor]
    opt_state: AdamStep
    # Ring replay buffer of per-point transitions
    buf_state: torch.Tensor  # (capacity, state_dim)
    buf_reward: torch.Tensor  # (capacity,)
    buf_next: torch.Tensor  # (capacity, state_dim)
    buf_done: torch.Tensor  # (capacity,)
    ptr: torch.Tensor  # () int64, on the device
    size: torch.Tensor  # () int64, on the device
    epsilon: torch.Tensor  # () float32, on the device
    steps: torch.Tensor  # () int64, on the device
    episode_reward: torch.Tensor  # () float32, on the device
    filled: int = 0  # host: min(size, batch_size, memory_size), counted without a read


class RLAgent:
    """DQN agent: policy and target networks, replay, epsilon decay."""

    def __init__(
        self,
        state_dim: int = 2,
        action_dim: int = 1,
        hidden_dim: int = 512,
        learning_rate: float = 1e-3,
        gamma: float = 0.99,
        epsilon_start: float = 1.0,
        epsilon_end: float = 0.01,
        epsilon_decay: float = 0.995,
        memory_size: int = 10000,
        batch_size: int = 124,
        target_update: int = 100,
        reward_weights: Optional[Dict[str, float]] = None,
        device: Optional[str | torch.device] = None,
    ) -> None:
        self.state_dim = state_dim
        self.action_dim = action_dim
        self.hidden_dim = hidden_dim
        self.learning_rate = float(learning_rate)
        self.gamma = gamma
        self.epsilon_end = epsilon_end
        self.epsilon_decay = epsilon_decay
        self.epsilon_start = epsilon_start
        self.memory_size = memory_size
        self.batch_size = batch_size
        self.target_update = target_update
        self.reward_weights = reward_weights or {
            "residual": 1.0,
            "boundary": 1.0,
            "initial": 1.0,
            "exploration": 0.1,
        }
        # The card unless the caller names a device; raises without one.
        self.device = torch.device(resolve_device("cuda") if device is None else device)
        # The structure that functional_call evaluates; its own weights are unused.
        self.network = DQNNetwork(state_dim, action_dim, hidden_dim).to(self.device)

    def init(self, generator: torch.Generator, capturable: bool = False) -> RLAgentState:
        """A fresh state; the weights are drawn from ``generator`` on the CPU
        (so a seed gives the same weights on every device) and moved. With
        ``capturable`` its Adam can be captured in a CUDA graph (the
        trainer's and the sampling harness's replayed steps)."""
        net = DQNNetwork(self.state_dim, self.action_dim, self.hidden_dim, generator)
        policy = {k: v.detach().to(self.device).requires_grad_(True)
                  for k, v in net.named_parameters()}
        target = {k: v.detach().clone() for k, v in policy.items()}
        cap, dev = self.memory_size, self.device

        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        return RLAgentState(
            policy_params=policy,
            target_params=target,
            opt_state=AdamStep(list(policy.values()), lambda count: self.learning_rate,
                               1.0, 0.9, 0.999, 0.0, capturable=capturable),
            buf_state=zeros(cap, self.state_dim),
            buf_reward=zeros(cap),
            buf_next=zeros(cap, self.state_dim),
            buf_done=zeros(cap),
            ptr=zeros(dtype=torch.int64),
            size=zeros(dtype=torch.int64),
            epsilon=torch.full((), self.epsilon_start, dtype=torch.float32, device=dev),
            steps=zeros(dtype=torch.int64),
            episode_reward=zeros(),
        )

    def apply(self, params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
        """The plain network on ``params`` (autograd-differentiable)."""
        return torch.func.functional_call(self.network, params, (x,))

    # ------------------------------------------------------------------ #
    # Acting
    # ------------------------------------------------------------------ #

    def select_action(self, state: RLAgentState, points: torch.Tensor,
                      generator: torch.Generator) -> torch.Tensor:
        """Epsilon-greedy scores over candidate points: policy Q with
        probability 1 - eps, uniform random scores with probability eps."""
        u_explore = torch.rand((), generator=generator, device=points.device)
        r = torch.rand((points.shape[0],), generator=generator, device=points.device)
        return self._select(state, points, u_explore, r)

    def _select(self, state: RLAgentState, points: torch.Tensor, u_explore: torch.Tensor,
                r: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            q = mlp.fused_mlp_score(points, state.policy_params)[..., 0]
            return torch.where(u_explore < state.epsilon, r, q)

    def score_fn(self, state: RLAgentState, generator: torch.Generator):
        """``sample_adaptive``'s ``score_fn(grid)`` hook for this state."""
        return lambda grid: self.select_action(state, grid, generator)

    def compute_reward(self, residual_loss, boundary_loss, initial_loss, exploration_bonus=0.0):
        """reward = -sum(w_i * loss_i) + w_explore * bonus, element-wise
        (per-point |residual| with the step's scalar BC and IC losses)."""
        w = self.reward_weights
        return (
            -w["residual"] * residual_loss
            - w["boundary"] * boundary_loss
            - w["initial"] * initial_loss
            + w["exploration"] * exploration_bonus
        )

    # ------------------------------------------------------------------ #
    # Learning
    # ------------------------------------------------------------------ #

    def push(self, state: RLAgentState, s: torch.Tensor, r: torch.Tensor,
             s_next: torch.Tensor, done: torch.Tensor) -> RLAgentState:
        """Write a batch of per-point transitions into the ring buffer."""
        n = s.shape[0]
        cap = self.memory_size
        idx = (torch.arange(n, device=state.buf_state.device) + state.ptr) % cap
        state.buf_state.index_copy_(0, idx, s.to(state.buf_state.dtype))
        state.buf_reward.index_copy_(0, idx, torch.broadcast_to(r, (n,)).to(state.buf_reward.dtype))
        state.buf_next.index_copy_(0, idx, s_next.to(state.buf_next.dtype))
        state.buf_done.index_copy_(0, idx, torch.broadcast_to(done, (n,)).to(state.buf_done.dtype))
        state.ptr.copy_((state.ptr + n) % cap)
        state.size.copy_(torch.clamp(state.size + n, max=cap))
        state.filled = min(state.filled + n, self.batch_size, cap)
        return state

    def settled(self, state: RLAgentState) -> bool:
        """Whether ``update``'s train branch can no longer change: the
        buffer holds a batch, or is full below one."""
        return state.filled >= min(self.batch_size, self.memory_size)

    def _td_loss(self, policy_params, target_params,
                 batch: Tuple[torch.Tensor, ...]) -> torch.Tensor:
        """Huber (delta 1) TD loss; the target network's max is taken even
        where done = 1."""
        s, r, s_next, done = batch
        q = self.apply(policy_params, s)[..., 0]
        with torch.no_grad():
            q_next = self.apply(target_params, s_next).max(dim=-1).values
            target = r + (1.0 - done) * self.gamma * q_next
        return F.huber_loss(q, target, delta=1.0)

    def _train(self, state: RLAgentState, generator: torch.Generator) -> RLAgentState:
        # Uniform over [0, size) with the bound on the device.
        u = torch.rand((self.batch_size,), generator=generator, dtype=torch.float64,
                       device=state.buf_state.device)
        return self._train_on(state, (u * torch.clamp(state.size, min=1)).long())

    def _train_on(self, state: RLAgentState, idx: torch.Tensor) -> RLAgentState:
        """One clipped Adam step on the TD loss of the transitions at ``idx``."""
        batch = tuple(buf.index_select(0, idx) for buf in
                      (state.buf_state, state.buf_reward, state.buf_next, state.buf_done))
        params = list(state.policy_params.values())
        with torch.enable_grad():
            loss = self._td_loss(state.policy_params, state.target_params, batch)
            grads = torch.autograd.grad(loss, params)
        for p, g in zip(params, grads):
            p.grad = g
        state.opt_state.step()
        return state

    def update(self, state: RLAgentState, s: torch.Tensor, reward: torch.Tensor,
               s_next: torch.Tensor, done: torch.Tensor,
               generator: torch.Generator) -> RLAgentState:
        """push -> target sync every ``target_update`` steps -> train when the
        buffer holds at least ``batch_size``. Epsilon decays once per epoch
        in the trainer (``update_epsilon``), not here."""
        state = self.push(state, s, reward, s_next, done)
        state.steps.add_(1)
        state.episode_reward.add_(torch.mean(reward))
        sync = (state.steps % self.target_update) == 0
        with torch.no_grad():
            for k, p in state.policy_params.items():
                target = state.target_params[k]
                target.copy_(torch.where(sync, p, target))
        if state.filled >= self.batch_size:
            state = self._train(state, generator)
        return state

    def update_epsilon(self, state: RLAgentState) -> RLAgentState:
        state.epsilon.copy_(torch.clamp(state.epsilon * self.epsilon_decay, min=self.epsilon_end))
        return state

    def get_statistics(self, state: RLAgentState) -> Dict[str, float]:
        return {
            "epsilon": float(state.epsilon),
            "steps": int(state.steps),
            "buffer_size": int(state.size),
            "episode_reward": float(state.episode_reward),
        }

    # ------------------------------------------------------------------ #
    # Persistence
    # ------------------------------------------------------------------ #

    _BUFFERS = ("buf_state", "buf_reward", "buf_next", "buf_done", "epsilon", "episode_reward")
    _COUNTERS = ("ptr", "size", "steps")

    def state_arrays(self, state: RLAgentState) -> Dict[str, np.ndarray]:
        """``state`` as numpy arrays (see the module docstring)."""
        from pinnrl_tpu_torch.models.bridge import dqn_params_to_flax

        out = {}
        for tag, net in (("policy", state.policy_params), ("target", state.target_params)):
            params = dqn_params_to_flax({k: v.detach() for k, v in net.items()})
            for module, leaves in params.items():
                for leaf, value in leaves.items():
                    out[f"{tag}/{module}/{leaf}"] = value
        opt = state.opt_state
        for name, p in state.policy_params.items():
            for key, value in opt.optimizer.state.get(p, {}).items():
                out[f"adam/{name}/{key}"] = value.detach().cpu().numpy()
        out["adam_count"] = np.asarray(opt.count)
        for name in self._BUFFERS + self._COUNTERS:
            out[name] = getattr(state, name).detach().cpu().numpy()
        return out

    def save_state(self, path: str, state: RLAgentState) -> None:
        """``state`` as an ``.npz`` (``state_arrays``)."""
        with open(path, "wb") as f:
            np.savez(f, **self.state_arrays(state))

    def load_arrays(self, arrays: Dict[str, np.ndarray], template: RLAgentState) -> RLAgentState:
        """Fill ``template`` (a state of this agent, e.g. ``init``'s) in
        place with what ``state_arrays`` gave, and return it."""
        from pinnrl_tpu_torch.models.bridge import dqn_params_from_flax

        with torch.no_grad():
            for tag, net in (("policy", template.policy_params), ("target", template.target_params)):
                tree: Dict[str, Dict[str, np.ndarray]] = {}
                for key, value in arrays.items():
                    if key.startswith(f"{tag}/"):
                        _, module, leaf = key.split("/")
                        tree.setdefault(module, {})[leaf] = value
                for k, v in dqn_params_from_flax(tree).items():
                    net[k].copy_(v)
            opt = template.opt_state
            for name, p in template.policy_params.items():
                saved = {key.rsplit("/", 1)[1]: v for key, v in arrays.items()
                         if key.startswith(f"adam/{name}/")}
                if saved:
                    opt.load_state(p, saved)
            opt.count = int(arrays["adam_count"])
            for name in self._BUFFERS + self._COUNTERS:
                getattr(template, name).copy_(torch.as_tensor(arrays[name]))
        template.filled = min(int(arrays["size"]), self.batch_size, self.memory_size)
        return template

    def load_state(self, path: str, template: RLAgentState) -> RLAgentState:
        """Load what ``save_state`` wrote into ``template`` (see ``load_arrays``)."""
        with np.load(path) as data:
            return self.load_arrays({k: data[k] for k in data.files}, template)


@dataclass
class CollocationAgentState:
    params: Dict[str, torch.Tensor]  # Dense_0..Dense_L, torch layout
    opt_state: AdamStep
    epsilon: torch.Tensor  # () float32, on the device


def _lecun_dense(in_dim: int, out_dim: int, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """flax ``nn.Dense``'s init: a lecun-normal kernel (a normal truncated
    at two deviations, rescaled to variance 1 / fan_in) and a zero bias."""
    std = (1.0 / in_dim) ** 0.5 / 0.87962566103423978
    w = torch.empty(out_dim, in_dim)
    nn.init.trunc_normal_(w, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)
    return {"weight": w, "bias": torch.zeros(out_dim)}


class CollocationAgent:
    """The lighter point scorer: a ReLU MLP (``num_layers`` Dense + ReLU,
    then a Dense head) with a naive Q update, no replay buffer and no target
    network (``pinnrl_tpu.rl.dqn.CollocationAgent``). Its parameters use the
    bridge's names (``Dense_i.weight`` / ``Dense_i.bias``); methods update
    the state in place and return it. ``get_action`` draws from a
    ``torch.Generator`` and hands the draws to ``_act``."""

    def __init__(self, state_dim: int = 2, action_dim: int = 1, hidden_dim: int = 64,
                 num_layers: int = 3, learning_rate: float = 1e-3, gamma: float = 0.99,
                 epsilon_start: float = 1.0, epsilon_end: float = 0.01,
                 epsilon_decay: float = 0.995, device: Optional[str | torch.device] = None) -> None:
        self.state_dim = state_dim
        self.action_dim = action_dim
        self.hidden_dim = hidden_dim
        self.num_layers = num_layers
        self.learning_rate = float(learning_rate)
        self.gamma = gamma
        self.epsilon_start = epsilon_start
        self.epsilon_end = epsilon_end
        self.epsilon_decay = epsilon_decay
        # The card unless the caller names a device; raises without one.
        self.device = torch.device(resolve_device("cuda") if device is None else device)

    def init(self, generator: torch.Generator) -> CollocationAgentState:
        """A fresh state; the weights are drawn from ``generator`` on the CPU
        and moved."""
        params = {}
        dims = [self.state_dim] + [self.hidden_dim] * self.num_layers + [self.action_dim]
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            for leaf, v in _lecun_dense(a, b, generator).items():
                params[f"Dense_{i}.{leaf}"] = v.to(self.device).requires_grad_(True)
        return CollocationAgentState(
            params=params,
            opt_state=AdamStep(list(params.values()), lambda count: self.learning_rate,
                               None, 0.9, 0.999, 0.0),
            epsilon=torch.full((), self.epsilon_start, dtype=torch.float32, device=self.device),
        )

    def apply(self, params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers):
            x = F.relu(F.linear(x, params[f"Dense_{i}.weight"], params[f"Dense_{i}.bias"]))
        L = self.num_layers
        return F.linear(x, params[f"Dense_{L}.weight"], params[f"Dense_{L}.bias"])

    def _act(self, state: CollocationAgentState, points: torch.Tensor, u: torch.Tensor,
             r: torch.Tensor) -> torch.Tensor:
        """Random scores ``r`` where ``u < epsilon`` (explore), else Q."""
        with torch.no_grad():
            q = self.apply(state.params, points)
        return torch.where(u < state.epsilon, r, q)

    def get_action(self, state: CollocationAgentState, points: torch.Tensor,
                   generator: torch.Generator) -> torch.Tensor:
        """Epsilon-greedy scores of ``points`` (N, state_dim): Q, or normal
        random scores when it explores."""
        u = torch.rand((), generator=generator, device=points.device)
        r = torch.randn((points.shape[0], self.action_dim), generator=generator,
                        device=points.device)
        return self._act(state, points, u, r)

    def update(self, state: CollocationAgentState, s: torch.Tensor, reward: torch.Tensor,
               s_next: torch.Tensor) -> CollocationAgentState:
        """One Adam step on mean((Q(s) - (reward + gamma Q(s')))^2), Q(s')
        detached; ``reward`` broadcasts against Q's (N, action_dim) as in
        the JAX package."""
        p = state.params
        with torch.no_grad():
            q_next = self.apply(p, s_next)
        q = self.apply(p, s)
        loss = torch.mean((q - (reward + self.gamma * q_next)) ** 2)
        for leaf in state.opt_state.params:
            leaf.grad = None
        loss.backward()
        state.opt_state.step()
        return state

    def update_epsilon(self, state: CollocationAgentState) -> CollocationAgentState:
        state.epsilon = torch.clamp(state.epsilon * self.epsilon_decay, min=self.epsilon_end)
        return state
