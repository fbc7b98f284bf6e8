"""A3C actor-critic with a vectorized environment, on PyTorch.

The port of `shockwave_tpu/models/a3c.py`. The reference's actors are a
batch dimension of a Catch/Pong-style grid environment (a ball falls one
row a step, drifting by its dx; the paddle on the last row moves left,
stays or moves right), and one update is an n-step unroll followed by
one actor-critic gradient step with GAE advantages.

The JAX version draws its random numbers from per-environment threefry
keys, which PyTorch cannot replay. Here the draws come from a
`torch.Generator` and are split out of the transition: `reset_draws`
draws a column and a dx for every environment at every step (used where
an episode ends, as the reference's auto-reset does), and `env_step` is
exact given them, so a test can feed it the JAX version's own draws.
Actions are sampled by the Gumbel-max rule, as `jax.random.categorical`
samples them, from the same generator.

Observations are NHWC, as in the JAX package; `ActorCritic` views them
as NCHW for its convolutions and flattens its features back in NHWC
order, so flax's Dense kernel carries over unchanged.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .resnet import same_pads
from .transformer import lecun_normal_

GRID_H = 16
GRID_W = 16
NUM_ACTIONS = 3  # left, stay, right


class EnvState(NamedTuple):
    ball_y: torch.Tensor    # [B] int64
    ball_x: torch.Tensor    # [B] int64
    ball_dx: torch.Tensor   # [B] int64 in {-1, 0, 1}
    paddle_x: torch.Tensor  # [B] int64


def reset_draws(gen: torch.Generator, batch: int, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """A fresh ball column in [0, GRID_W) and dx in {-1, 0, 1} per
    environment, from `gen` (on `device`, the generator's)."""
    cols = torch.randint(0, GRID_W, (batch,), generator=gen, device=device)
    dxs = torch.randint(-1, 2, (batch,), generator=gen, device=device)
    return cols, dxs


def env_reset(gen: torch.Generator, batch: int, device=None) -> EnvState:
    cols, dxs = reset_draws(gen, batch, device)
    return EnvState(ball_y=torch.zeros_like(cols), ball_x=cols, ball_dx=dxs,
                    paddle_x=torch.full_like(cols, GRID_W // 2))


def env_observe(state: EnvState) -> torch.Tensor:
    """[B, H, W, 2] float32 one-hot planes (ball, paddle)."""
    b = state.ball_y.shape[0]
    rows = torch.arange(b, device=state.ball_y.device)
    obs = torch.zeros(b, GRID_H, GRID_W, 2, device=state.ball_y.device)
    obs[rows, state.ball_y, state.ball_x, 0] = 1.0
    obs[rows, GRID_H - 1, state.paddle_x, 1] = 1.0
    return obs


def env_step(state: EnvState, action, reset_col, reset_dx):
    """Batched transition, with an environment whose episode ends reset
    to (`reset_col`, `reset_dx`). Returns (next_state, reward, done)."""
    paddle = (state.paddle_x + action - 1).clamp(0, GRID_W - 1)
    ball_x = (state.ball_x + state.ball_dx).clamp(0, GRID_W - 1)
    ball_y = state.ball_y + 1
    done = ball_y >= GRID_H - 1
    reward = torch.where(done, torch.where(ball_x == paddle, 1.0, -1.0), 0.0)
    return (EnvState(ball_y=torch.where(done, 0, ball_y),
                     ball_x=torch.where(done, reset_col, ball_x),
                     ball_dx=torch.where(done, reset_dx, state.ball_dx),
                     paddle_x=paddle), reward, done)


class ActorCritic(nn.Module):
    """Conv torso + policy/value heads: flax's Conv_0, Conv_1 (3x3,
    `SAME`, the second strided by 2), Dense_0 (hidden), Dense_1 (logits)
    and Dense_2 (value), all f32."""

    def __init__(self, hidden: int = 128, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.convs = nn.ModuleList([nn.Conv2d(2, 16, 3), nn.Conv2d(16, 32, 3, stride=2)])
        flat = 32 * -(-GRID_H // 2) * -(-GRID_W // 2)
        self.dense = nn.ModuleList([nn.Linear(flat, hidden), nn.Linear(hidden, NUM_ACTIONS),
                                    nn.Linear(hidden, 1)])
        generator = generator if generator is not None else torch.Generator().manual_seed(0)
        with torch.no_grad():
            for layer in (*self.convs, *self.dense):
                lecun_normal_(layer.weight, layer.weight[0].numel(), generator)
                layer.bias.zero_()

    def forward(self, obs):
        """obs (B, H, W, 2) f32 -> (logits (B, 3), value (B,))."""
        x = obs.permute(0, 3, 1, 2)
        if not x.is_cuda:
            x = x.contiguous()  # NCHW on the CPU (see models/resnet.py)
        for conv in self.convs:
            stride = conv.stride[0]
            (top, bottom), (left, right) = (same_pads(n, 3, stride) for n in x.shape[2:])
            x = F.relu(conv(F.pad(x, (left, right, top, bottom))))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flax's NHWC flatten
        x = F.relu(self.dense[0](x))
        return self.dense[1](x), self.dense[2](x)[..., 0]


def sample_actions(logits, gen: torch.Generator):
    """One action per row by the Gumbel-max rule: argmax(logits - log E)
    with E ~ Exp(1) drawn from `gen`."""
    noise = torch.empty_like(logits).exponential_(generator=gen)
    return torch.argmax(logits - torch.log(noise), dim=-1)


def a3c_loss(model, traj, last_value, gamma: float = 0.99, tau: float = 1.0,
             value_coef: float = 0.5, entropy_coef: float = 0.01):
    """The reference's `loss_fn`: GAE advantages over the time-major [T, B]
    trajectory (obs, actions, rewards, dones, values), the policy
    re-evaluated on its observations. Returns (loss, metrics)."""
    obs, actions, rewards, dones, values = traj
    not_done = 1.0 - dones.float()
    gae, next_value = torch.zeros_like(last_value), last_value
    advs = []
    for t in range(rewards.shape[0] - 1, -1, -1):
        delta = rewards[t] + gamma * next_value * not_done[t] - values[t]
        gae = delta + gamma * tau * not_done[t] * gae
        next_value = values[t]
        advs.append(gae)
    advs = torch.stack(advs[::-1]).detach()
    returns = advs + values
    logits, value = model(obs.reshape((-1,) + obs.shape[2:]))
    logp = F.log_softmax(logits, dim=-1).reshape(rewards.shape + (NUM_ACTIONS,))
    value = value.reshape(rewards.shape)
    taken = logp.gather(-1, actions[..., None])[..., 0]
    policy_loss = -(taken * advs).mean()
    value_loss = ((value - returns.detach()) ** 2).mean()
    entropy = -(logp.exp() * logp).sum(-1).mean()
    loss = policy_loss + value_coef * value_loss - entropy_coef * entropy
    return loss, {"policy_loss": policy_loss.detach(), "value_loss": value_loss.detach(),
                  "entropy": entropy.detach(), "reward": rewards.sum(0).mean()}


def build_a3c_update(model: ActorCritic, optimizer: torch.optim.Optimizer, unroll: int = 20,
                     **loss_kwargs):
    """One A3C tick, `update(env_state, gen) -> (env_state, metrics)`:
    unroll `unroll` environment steps with the current policy (actions
    and reset draws from `gen`), compute GAE advantages, apply one
    optimizer step. Metrics stay on the device."""

    def rollout(env_state, gen):
        steps = []
        for _ in range(unroll):
            obs = env_observe(env_state)
            logits, value = model(obs)
            action = sample_actions(logits, gen)
            reset_col, reset_dx = reset_draws(gen, obs.shape[0], obs.device)
            next_state, reward, done = env_step(env_state, action, reset_col, reset_dx)
            steps.append((obs, action, reward, done, value))
            env_state = next_state
        return env_state, tuple(torch.stack(x) for x in zip(*steps))

    def update(env_state, gen):
        with torch.no_grad():
            env_state, traj = rollout(env_state, gen)
            _, last_value = model(env_observe(env_state))
        optimizer.zero_grad(set_to_none=True)
        loss, metrics = a3c_loss(model, traj, last_value, **loss_kwargs)
        loss.backward()
        optimizer.step()
        metrics["loss"] = loss.detach()
        return env_state, metrics

    return update


__all__ = ["EnvState", "env_reset", "env_observe", "env_step", "reset_draws",
           "ActorCritic", "sample_actions", "a3c_loss", "build_a3c_update"]
