"""RL-driven collocation sampling: the DQN agent (``rl/dqn.py``)."""

from pinnrl_tpu_torch.rl.dqn import (  # noqa: F401
    CollocationAgent,
    CollocationAgentState,
    DQNNetwork,
    RLAgent,
    RLAgentState,
)
