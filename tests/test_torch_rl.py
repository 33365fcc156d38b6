"""The DQN agent and the fused MLP scorer of the port against pinnrl_tpu.rl.

Parameters are bridged from flax; inputs are made with numpy from a seed;
every random draw of the port is replaced by the draw JAX makes under its
own key (``_select``, ``_train_on`` and the sampler helpers take their draws
as tensors). On the CPU the JAX ``fused_mlp_score`` takes its jnp path,
which is the JAX package's reference for the kernel.

Tolerances (each with its reason):
- scorer and Q values 1e-5 relative to max: both sides are f32 with the
  same two-pass LayerNorm; only the summation order differs;
- the host launcher with the plain twins 1e-6: the same torch operations,
  one GEMM through ``as_strided`` views (against JAX at the shipped width,
  with the product split over K, the scorer's 1e-5);
- TD loss and gradients 1e-5 relative to max (f32, same formulas);
- policy parameters after one Adam step 2.5e-4 absolute: a quarter of one
  step at lr 1e-3, since Adam turns gradient differences near zero into
  full-size steps (the same reason as the trainer test's 5e-4 at lr 2e-3);
- residual score and reward after one PINN Adam step 1e-4 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_parity_helpers import burgers_pair, inject_points, jax_bc_ic_points, rel_to_max

from pinnrl_tpu.ops.kernels.mlp import fused_mlp_score as jax_fused_mlp_score
from pinnrl_tpu.rl import RLAgent as JaxRLAgent
from pinnrl_tpu.training.trainer import PDETrainer as JaxTrainer
from pinnrl_tpu_torch.models.bridge import dqn_params_from_flax, dqn_params_to_flax
from pinnrl_tpu_torch.ops.kernels import mlp
from pinnrl_tpu_torch.rl import CollocationAgent, RLAgent
from pinnrl_tpu_torch.sampling import make_grid
from pinnrl_tpu_torch.sampling.strategies import _adaptive_pick, _bounds
from pinnrl_tpu_torch.training import PDETrainer

SCORE_TOL = 1e-5
REHEARSAL_TOL = 1e-6
GRAD_TOL = 1e-5
PARAM_ATOL = 2.5e-4
STEP_TOL = 1e-4


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jitter(params, seed, scale=0.1):
    """Move every leaf off flax's init (LayerNorm (1, 0), zero biases)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: a + scale * rng.standard_normal(a.shape).astype(np.float32), params)


def _load(dst, flax_params):
    with torch.no_grad():
        for k, v in dqn_params_from_flax(_np_tree(flax_params)).items():
            dst[k].copy_(v)


def agent_pair(hidden=32, action_dim=1, memory=64, batch=16, epsilon=1.0, jitter=True, **kw):
    """A JAX agent and state, and the port's with the same parameters."""
    args = dict(state_dim=2, action_dim=action_dim, hidden_dim=hidden, memory_size=memory,
                batch_size=batch, epsilon_start=epsilon, **kw)
    jagent = JaxRLAgent(**args)
    jstate = jagent.init(jax.random.PRNGKey(0))
    if jitter:
        jstate = jstate.replace(policy_params=_jitter(jstate.policy_params, 1),
                                target_params=_jitter(jstate.target_params, 2))
    tagent = RLAgent(**args, device="cpu")
    tstate = tagent.init(torch.Generator().manual_seed(0))
    _load(tstate.policy_params, jstate.policy_params)
    _load(tstate.target_params, jstate.target_params)
    return jagent, jstate, tagent, tstate


def _grid_points(seed, n):
    return np.random.default_rng(seed).uniform(-1.0, 1.0, (n, 2)).astype(np.float32)


def test_dqn_bridge_round_trip_is_exact():
    from pinnrl_tpu.rl import DQNNetwork as JaxDQN

    params = _np_tree(JaxDQN(action_dim=3, hidden_dim=24).init(
        jax.random.PRNGKey(4), jnp.zeros((1, 2)))["params"])
    state = dqn_params_from_flax(params)
    assert state["Dense_0.weight"].shape == (24, 2) and state["Dense_2.weight"].shape == (3, 24)
    back = dqn_params_to_flax(state)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(KeyError):
        dqn_params_from_flax({"Dense_0": params["Dense_0"]})


@pytest.mark.parametrize("action_dim,hidden", [(1, 32), (4, 64)])
def test_fused_mlp_score_plain_matches_jax(action_dim, hidden):
    jagent, jstate, tagent, tstate = agent_pair(hidden=hidden, action_dim=action_dim)
    x = _grid_points(3, 300)
    ref_kernel = np.asarray(jax_fused_mlp_score(jnp.asarray(x), jstate.policy_params))
    ref_net = np.asarray(jagent.network.apply({"params": jstate.policy_params}, jnp.asarray(x)))
    with torch.no_grad():
        got = mlp.fused_mlp_score_plain(torch.from_numpy(x), tstate.policy_params)
    assert got.shape == (300, action_dim)
    assert rel_to_max(got, ref_kernel) < SCORE_TOL
    assert rel_to_max(got, ref_net) < SCORE_TOL
    with torch.no_grad():  # the port's network (autograd path of the TD loss)
        assert rel_to_max(tagent.apply(tstate.policy_params, torch.from_numpy(x)), ref_net) < SCORE_TOL


@pytest.mark.parametrize("n,action_dim,hidden", [(300, 1, 32), (77, 4, 64), (1, 2, 40)])
def test_kernel_launcher_rehearsal_matches_plain(n, action_dim, hidden):
    """The CUDA launch sequence (first layer, strided GEMM, head) run with
    the plain twins on the CPU equals the plain version."""
    _, _, _, tstate = agent_pair(hidden=hidden, action_dim=action_dim)
    x = torch.from_numpy(_grid_points(5, n))
    params = {k: v.detach() for k, v in tstate.policy_params.items()}
    got = mlp._score(mlp._TorchOps(), x, params, 1e-6)
    assert got.shape == (n, action_dim)
    assert rel_to_max(got, mlp.fused_mlp_score_plain(x, params)) < REHEARSAL_TOL


def test_kernel_launcher_rehearsal_at_the_shipped_width_matches_jax():
    """The CUDA launch sequence with the plain twins at the shipped agent
    (hidden 512, action_dim 1) on the 100x100 grid of the Burgers domain,
    where the product is split in two over K, against the JAX
    ``fused_mlp_score`` on the same flax parameters."""
    _, jstate, _, tstate = agent_pair(hidden=512, action_dim=1)
    axes = np.meshgrid(np.linspace(-1.0, 1.0, 100), np.linspace(0.0, 1.0, 100), indexing="ij")
    x = np.stack([a.reshape(-1) for a in axes], axis=-1).astype(np.float32)
    assert mlp._product_split(x.shape[0], 512, 512)[0] == 2
    ref = np.asarray(jax_fused_mlp_score(jnp.asarray(x), jstate.policy_params))
    params = {k: v.detach() for k, v in tstate.policy_params.items()}
    got = mlp._score(mlp._TorchOps(), torch.from_numpy(x), params, 1e-6)
    assert got.shape == (10000, 1)
    assert rel_to_max(got, ref) < SCORE_TOL


@pytest.mark.parametrize("epsilon", [0.0, 1.0])
def test_select_action_matches_jax(epsilon):
    jagent, jstate, tagent, tstate = agent_pair(epsilon=epsilon)
    x = _grid_points(6, 50)
    key = jax.random.PRNGKey(5)
    ref = np.asarray(jagent.select_action(jstate, jnp.asarray(x), key))
    k_bern, k_rand = jax.random.split(key)
    u = torch.from_numpy(np.array(jax.random.uniform(k_bern)))
    r = torch.from_numpy(np.array(jax.random.uniform(k_rand, (50,))))
    xt = torch.from_numpy(x)
    got = tagent._select(tstate, xt, u, r)
    with torch.no_grad():
        q = tagent.apply(tstate.policy_params, xt)[:, 0]
    if epsilon == 0.0:
        assert rel_to_max(got, ref) < SCORE_TOL
        assert rel_to_max(got, q) < SCORE_TOL
        drawn = tagent.select_action(tstate, xt, torch.Generator().manual_seed(1))
        assert torch.equal(drawn, got)  # greedy: the draws do not matter
    else:
        assert torch.equal(got, r)
        np.testing.assert_array_equal(got.numpy(), ref)


def test_push_wraps_the_ring_buffer_like_jax():
    jagent, jstate, tagent, tstate = agent_pair(memory=32)
    rng = np.random.default_rng(7)
    for n, done in ((20, 0.0), (20, 1.0), (9, 0.0)):
        s = rng.standard_normal((n, 2)).astype(np.float32)
        s2 = rng.standard_normal((n, 2)).astype(np.float32)
        r = rng.standard_normal(n).astype(np.float32)
        jstate = jagent.push(jstate, jnp.asarray(s), jnp.asarray(r), jnp.asarray(s2), jnp.asarray(done))
        tstate = tagent.push(tstate, torch.from_numpy(s), torch.from_numpy(r), torch.from_numpy(s2),
                             torch.tensor(done))
        assert (tstate.ptr, tstate.size) == (int(jstate.ptr), int(jstate.size))
        for name in ("buf_state", "buf_reward", "buf_next", "buf_done"):
            np.testing.assert_array_equal(getattr(tstate, name).numpy(), np.asarray(getattr(jstate, name)))
    assert (tstate.ptr, tstate.size) == (17, 32)


def _filled_pair(**kw):
    jagent, jstate, tagent, tstate = agent_pair(**kw)
    rng = np.random.default_rng(8)
    n = 40
    s = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    s2 = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    r = rng.standard_normal(n).astype(np.float32)
    done = (rng.random(n) < 0.5).astype(np.float32)  # the target network counts where done = 0
    jstate = jagent.push(jstate, *map(jnp.asarray, (s, r, s2, done)))
    tstate = tagent.push(tstate, *map(torch.from_numpy, (s, r, s2, done)))
    return jagent, jstate, tagent, tstate


def test_train_step_matches_jax():
    jagent, jstate, tagent, tstate = _filled_pair(batch=16)
    key = jax.random.PRNGKey(9)
    jidx = jax.random.randint(key, (16,), 0, max(int(jstate.size), 1))
    jbatch = tuple(b[jidx] for b in (jstate.buf_state, jstate.buf_reward, jstate.buf_next, jstate.buf_done))
    jloss, jgrads = jax.value_and_grad(jagent._td_loss)(jstate.policy_params, jstate.target_params, jbatch)

    idx = torch.from_numpy(np.array(jidx)).long()
    tbatch = tuple(b.index_select(0, idx) for b in (tstate.buf_state, tstate.buf_reward,
                                                      tstate.buf_next, tstate.buf_done))
    loss = tagent._td_loss(tstate.policy_params, tstate.target_params, tbatch)
    grads = torch.autograd.grad(loss, list(tstate.policy_params.values()))
    assert abs(float(loss.detach()) - float(jloss)) / abs(float(jloss)) < GRAD_TOL
    ref_grads = dqn_params_from_flax(_np_tree(jgrads))
    for name, g in zip(tstate.policy_params, grads):
        assert rel_to_max(g, ref_grads[name]) < GRAD_TOL, name

    jstate = jagent._train(jstate, key)
    tstate = tagent._train_on(tstate, idx)
    ref = dqn_params_from_flax(_np_tree(jstate.policy_params))
    for name, p in tstate.policy_params.items():
        assert float((p.detach() - ref[name]).abs().max()) < PARAM_ATOL, name


def test_target_sync_falls_on_target_update_steps():
    _, _, tagent, tstate = agent_pair(batch=10_000, target_update=3)  # never trains
    s = torch.zeros((4, 2))
    for step in range(1, 8):
        with torch.no_grad():
            for p in tstate.policy_params.values():
                p.add_(1.0)
        before = {k: v.clone() for k, v in tstate.target_params.items()}
        tstate = tagent.update(tstate, s, torch.ones(4), s, torch.ones(()), torch.Generator())
        assert tstate.steps == step
        synced = step % 3 == 0
        for k, v in tstate.target_params.items():
            assert torch.equal(v, tstate.policy_params[k].detach() if synced else before[k]), (step, k)


def test_update_trains_once_the_buffer_holds_a_batch():
    _, _, tagent, tstate = agent_pair(batch=8, target_update=100)
    p0 = {k: v.detach().clone() for k, v in tstate.policy_params.items()}
    s = torch.rand((4, 2), generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    tstate = tagent.update(tstate, s, torch.ones(4), s, torch.ones(()), gen)
    assert all(torch.equal(p0[k], v) for k, v in tstate.policy_params.items())  # 4 < 8
    tstate = tagent.update(tstate, s, torch.ones(4), s, torch.ones(()), gen)
    assert any(not torch.equal(p0[k], v) for k, v in tstate.policy_params.items())
    assert float(tstate.epsilon) == 1.0  # update() does not decay epsilon
    stats = tagent.get_statistics(tstate)
    assert stats["steps"] == 2 and stats["buffer_size"] == 8
    assert stats["episode_reward"] == pytest.approx(2.0)


def test_compute_reward_matches_jax():
    weights = {"residual": 0.7, "boundary": 1.3, "initial": 0.4, "exploration": 0.2}
    jagent = JaxRLAgent(hidden_dim=8, reward_weights=weights)
    tagent = RLAgent(hidden_dim=8, reward_weights=weights, device="cpu")
    rng = np.random.default_rng(10)
    res = np.abs(rng.standard_normal(64)).astype(np.float32)
    b, i, bonus = np.float32(0.37), np.float32(2.5), np.float32(0.8)
    ref = np.asarray(jagent.compute_reward(jnp.asarray(res), jnp.asarray(b), jnp.asarray(i), jnp.asarray(bonus)))
    got = tagent.compute_reward(torch.from_numpy(res), torch.tensor(b), torch.tensor(i), torch.tensor(bonus))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-7)


def test_update_epsilon_follows_the_jax_schedule():
    jagent, jstate, tagent, tstate = agent_pair(epsilon_decay=0.97, epsilon_end=0.05)
    for _ in range(150):  # past the floor
        jstate = jagent.update_epsilon(jstate)
        tstate = tagent.update_epsilon(tstate)
        np.testing.assert_allclose(float(tstate.epsilon), float(jstate.epsilon), rtol=1e-6)
    assert float(tstate.epsilon) == pytest.approx(0.05)


def test_unported_agent_parts_raise(tmp_path):
    """CollocationAgent is ported (it builds on the CPU, and defaults to the
    card, raising without one); saving and loading an agent's state is
    ported: a state after a few updates round-trips exactly (weights,
    Adam moments and counts, replay buffer, epsilon, counters)."""
    _, _, tagent, tstate = agent_pair(batch=8)
    assert CollocationAgent(device="cpu").init(torch.Generator().manual_seed(0)).params
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            CollocationAgent()
    gen = torch.Generator().manual_seed(2)
    for _ in range(3):
        s = torch.rand((8, 2), generator=gen)
        tstate = tagent.update(tstate, s, torch.rand(8, generator=gen), s, torch.ones(()), gen)
    tstate = tagent.update_epsilon(tstate)
    tagent.save_state(str(tmp_path / "rl_agent.npz"), tstate)
    loaded = tagent.load_state(str(tmp_path / "rl_agent.npz"),
                               tagent.init(torch.Generator().manual_seed(9)))
    for tag in ("policy_params", "target_params"):
        for k, v in getattr(tstate, tag).items():
            assert torch.equal(getattr(loaded, tag)[k], v), (tag, k)
    for name in ("buf_state", "buf_reward", "buf_next", "buf_done", "epsilon", "episode_reward"):
        assert torch.equal(getattr(loaded, name), getattr(tstate, name)), name
    assert (loaded.ptr, loaded.size, loaded.steps) == (tstate.ptr, tstate.size, tstate.steps)
    assert loaded.opt_state.count == tstate.opt_state.count == 3  # a batch of 8 from the first update on
    saved_opt, new_opt = tstate.opt_state.optimizer.state, loaded.opt_state.optimizer.state
    for p, q in zip(tstate.policy_params.values(), loaded.policy_params.values()):
        assert all(torch.equal(saved_opt[p][k], new_opt[q][k]) for k in saved_opt[p])


def test_one_rl_step_matches_jax(monkeypatch):
    """One RL training step composed from the public pieces, JAX's draws
    injected throughout: points, loss components, reward on the updated
    parameters, and the replay buffer after the agent's update."""
    pair = burgers_pair()
    jagent, jrl, tagent, trl = agent_pair(epsilon=0.0, memory=256, batch=16)
    jtr = JaxTrainer(pair.jmodel, pair.jpde, pair.jcfg, rl_agent=jagent)
    ttr = PDETrainer(pair.tmodel, pair.tpde, pair.tcfg, rl_agent=tagent)
    assert ttr.strategy == "adaptive" and ttr.fused_kernel_active
    n, n_push, ppa = 64, 64, 100

    _, k_samp, k_loss, k_rl = jax.random.split(jax.random.PRNGKey(11), 4)
    jparams = {"net": pair.jmodel.params, "coeffs": {}}
    x, t = jtr._sample(k_samp, n, jparams, jrl)
    (_, jl), jgrads = jax.value_and_grad(
        lambda p: (lambda L: (L["total"], L))(jtr._loss_components(p, x, t, k_loss)), has_aux=True)(jparams)
    jopt = jtr._make_adam(1, 4)
    updates, _ = jopt.update(jgrads, jopt.init(jparams), jparams)
    jnew = optax.apply_updates(jparams, updates)
    pts = jnp.concatenate([x[:n_push], t[:n_push]], axis=-1)
    jres = pair.jpde.residual_score(pair.jmodel.apply, jnew["net"], x[:n_push], t[:n_push], {})
    jreward = jagent.compute_reward(jres, jl["boundary"], jl["initial"])
    jrl = jagent.update(jrl, pts, jreward, pts, jnp.ones(()), k_rl)

    # 1. the same collocation points (the sampler's draws from JAX's keys)
    k_score, k_samp2 = jax.random.split(k_samp)
    k_bern, k_rand = jax.random.split(k_score)
    k_pick, k_jit = jax.random.split(k_samp2)

    def draw(arr):
        return torch.from_numpy(np.array(arr))

    grid = make_grid(pair.tpde.domain, pair.tpde.time_domain, ppa, device="cpu")
    scores = tagent._select(trl, grid, draw(jax.random.uniform(k_bern)),
                            draw(jax.random.uniform(k_rand, (ppa * ppa,))))
    lo, hi = _bounds(pair.tpde.domain, pair.tpde.time_domain, "cpu")
    tx, tt = _adaptive_pick(grid, scores, n, draw(jax.random.uniform(k_pick, (ppa * ppa,))),
                            draw(jax.random.uniform(k_jit, (n, 2), minval=-0.5, maxval=0.5)),
                            lo, hi, ppa)
    assert float((tx - draw(x)).abs().max()) < 1e-6 and float((tt - draw(t)).abs().max()) < 1e-6

    # 2. the same loss components on JAX's BC and IC points
    inject_points(monkeypatch, pair.tpde, *jax_bc_ic_points(pair.jpde, k_loss, n))
    params = pair.tmodel.params
    tl = ttr._loss_components(params, tx, tt, None)
    for k in ("residual", "boundary", "initial", "total"):
        assert abs(float(tl[k].detach()) - float(jl[k])) / abs(float(jl[k])) < 1e-5, k
    topt = ttr._make_adam(1, 4, list(params.values()))
    tl["total"].backward()
    topt.step()

    # 3. residual score on the updated parameters, and the reward
    with torch.no_grad():
        tres = pair.tpde.residual_score(pair.tmodel.apply, params, tx[:n_push], tt[:n_push])
        treward = tagent.compute_reward(tres, tl["boundary"].detach(), tl["initial"].detach())
    assert rel_to_max(tres, jres) < STEP_TOL
    assert rel_to_max(treward, jreward) < STEP_TOL

    # 4. the same buffer after the agent's update (JAX's TD indices injected)
    jidx = jax.random.randint(k_rl, (tagent.batch_size,), 0, n_push)
    monkeypatch.setattr(tagent, "_train", lambda st, gen: tagent._train_on(st, draw(jidx).long()))
    tpts = torch.cat([tx[:n_push], tt[:n_push]], dim=-1)
    trl = tagent.update(trl, tpts, treward, tpts, torch.ones(()), torch.Generator())
    assert (trl.ptr, trl.size, trl.steps) == (int(jrl.ptr), int(jrl.size), int(jrl.steps)) == (64, 64, 1)
    for name, tol in (("buf_state", 1e-6), ("buf_next", 1e-6), ("buf_reward", STEP_TOL), ("buf_done", 0.0)):
        got, ref = getattr(trl, name), np.array(getattr(jrl, name))
        assert float((got - torch.from_numpy(ref)).abs().max()) <= tol * max(np.abs(ref).max(), 1.0), name
    assert rel_to_max(trl.episode_reward, jrl.episode_reward) < STEP_TOL


def _small_trainer(distribution, agent=None):
    pair = burgers_pair()
    t = pair.tcfg.training
    t.num_collocation_points, t.batch_size, t.validation_frequency = 192, 64, 1
    t.collocation_distribution = distribution
    return PDETrainer(pair.tmodel, pair.tpde, pair.tcfg, rl_agent=agent), pair


def test_trainer_with_agent_returns_finite_history():
    agent = RLAgent(hidden_dim=32, memory_size=256, batch_size=16, device="cpu")
    trainer, pair = _small_trainer("uniform", agent)
    assert trainer.strategy == "adaptive"
    res = trainer.train(num_epochs=2, seed=0)
    hist = res["history"]
    assert len(hist["train_loss"]) == 2 and all(np.isfinite(hist["train_loss"] + hist["val_loss"]))
    st = trainer._final_state["rl"]
    assert (st.steps, st.size, st.ptr) == (6, 256, (6 * 64) % 256)  # 3 steps x 2 epochs, 64 pushed each
    assert float(st.epsilon) == pytest.approx(0.995**2, abs=1e-6)
    assert np.isfinite(agent.get_statistics(st)["episode_reward"])


def test_trainer_residual_based_returns_finite_history():
    trainer, _ = _small_trainer("residual_based")
    assert trainer.strategy == "residual_based" and trainer.rl_agent is None
    res = trainer.train(num_epochs=2, seed=0)
    assert res["status"] == "completed"
    assert all(np.isfinite(res["history"]["train_loss"] + res["history"]["val_loss"]))
    assert trainer._final_state["rl"] is None


def test_collocation_agent_matches_jax():
    """``CollocationAgent`` with bridged weights: its epsilon-greedy scores
    on JAX's draws exactly as JAX picks them, and the parameters after 3
    naive Q updates (plain Adam) at 1e-5; epsilon's decay at 1e-6."""
    from pinnrl_tpu.rl.dqn import CollocationAgent as JaxCollocationAgent
    from pinnrl_tpu_torch.models.bridge import params_from_flax, params_to_flax

    kw = dict(state_dim=2, hidden_dim=16, num_layers=3, learning_rate=1e-3, gamma=0.9,
              epsilon_start=0.5, epsilon_decay=0.9, epsilon_end=0.3)
    jagent = JaxCollocationAgent(**kw)
    jstate = jagent.init(jax.random.PRNGKey(0))
    tagent = CollocationAgent(**kw, device="cpu")
    tstate = tagent.init(torch.Generator().manual_seed(0))
    assert sorted(params_to_flax({k: v.detach() for k, v in tstate.params.items()})[0]) == \
        sorted(jstate.params)
    with torch.no_grad():
        for k, v in params_from_flax(_np_tree(jstate.params)).items():
            tstate.params[k].copy_(v)

    rng = np.random.default_rng(3)
    pts = rng.random((32, 2)).astype(np.float32)
    for seed in range(4):  # both branches: epsilon 0.5
        key = jax.random.PRNGKey(seed)
        ref = jagent.get_action(jstate, jnp.asarray(pts), key)
        u = torch.tensor(float(jax.random.uniform(key)))
        r = torch.from_numpy(np.asarray(jax.random.normal(key, ref.shape)))
        got = tagent._act(tstate, torch.from_numpy(pts), u, r)
        assert rel_to_max(got, ref) < SCORE_TOL, seed

    for step in range(3):
        s, s_next = (rng.random((32, 2)).astype(np.float32) for _ in range(2))
        reward = rng.standard_normal((32, 1)).astype(np.float32)
        jstate = jagent.update(jstate, jnp.asarray(s), jnp.asarray(reward), jnp.asarray(s_next))
        tstate = tagent.update(tstate, torch.from_numpy(s), torch.from_numpy(reward),
                               torch.from_numpy(s_next))
        jstate = jagent.update_epsilon(jstate)
        tstate = tagent.update_epsilon(tstate)
        np.testing.assert_allclose(float(tstate.epsilon), float(jstate.epsilon), rtol=1e-6)
    got = params_to_flax({k: v.detach() for k, v in tstate.params.items()})[0]
    for module, leaves in jstate.params.items():
        for leaf, ref in leaves.items():
            np.testing.assert_allclose(got[module][leaf], np.asarray(ref), rtol=0, atol=1e-5,
                                       err_msg=f"{module}/{leaf}")
