"""Device-mesh data parallelism in the port (``pinnrl_tpu_torch/parallel``)
on gloo process groups of 2 and 4 CPU processes, against the port's
unsharded runs and the JAX package's sharded loss on its 8 virtual CPU
devices. The ranks run in ``torch_mesh_worker`` (no JAX there).

Tolerances:
- histories (train and validation losses per epoch) against the unsharded
  run's at the padded batch: 1e-5 relative (the JAX suite allows its mesh 2e-3,
  tests/test_parallel.py); the ranks' histories and parameters: equal;
- one sharded loss against JAX's sharded loss on the same global batch and
  BC/IC draws: 1e-5 relative, each gradient 1e-4 relative to its max (the
  JAX suite's kernel bounds);
- the causal loss under the mesh (weights over the global batch) against
  the unsharded loss: 1e-5 relative, gradients 1e-4 relative to max (the
  unsharded side runs kernel 1's twin, the mesh the plain path).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_mesh_worker as worker
from torch_parity_helpers import (_configure, burgers_pair, jax_bc_ic_points, jax_grad_rels, points,
                                  rel_to_max)

from pinnrl_tpu.parallel import make_mesh as jax_make_mesh
from pinnrl_tpu.parallel import shard_batch as jax_shard_batch
from pinnrl_tpu.training import PDETrainer as JaxTrainer
from pinnrl_tpu_torch.config import load_config
from pinnrl_tpu_torch.parallel import Mesh, batch_sharding, pad_to_multiple, shard_batch
from pinnrl_tpu_torch.training import PDETrainer

N = 64  # the global batch of the one-loss cases


def _cfg(pair=None, **training):
    """The port's config of ``burgers_pair``'s small Burgers problem
    (Fourier 16x2, mapping 8; the pair's own when given), 64 points in
    batches of 32, one validation per epoch on 128 points."""
    cfg = pair.tcfg if pair is not None else _configure(
        load_config(pde_type="burgers", architecture="fourier", device="cpu"), hidden=(16, 16),
        mapping=8, periodic=True, layer_norm=True, scale=2.0, causal_eps=0.0)
    t = cfg.training
    t.num_collocation_points, t.batch_size, t.validation_frequency = 64, 32, 1
    for k, v in training.items():
        if k.startswith("lbfgs_"):
            setattr(t.lbfgs, k[len("lbfgs_"):], v)
        else:
            setattr(t, k, v)
    cfg.evaluation.num_points = 128
    return cfg


HISTORIES = {
    "adam": dict(),
    "padded": dict(batch_size=30),
    "causal": dict(causal_eps=1.0),
    "lbfgs": dict(optimizer="adam_lbfgs", adam_lbfgs_switch_ratio=0.5, lbfgs_batch_size=32),
}
EPOCHS = {"adam": 3, "padded": 2, "causal": 3, "lbfgs": 4}


@pytest.fixture(scope="module")
def sharded_jax():
    """JAX's sharded loss and gradients on its 8 virtual devices, with the
    bridged pair, the batch and the BC/IC draws it used."""
    pair = burgers_pair(hidden=(16, 16), mapping=8)
    x, t = points(21, N)
    key = jax.random.PRNGKey(5)
    mesh = jax_make_mesh()
    assert mesh.size == 8
    jtr = JaxTrainer(pair.jmodel, pair.jpde, pair.jcfg, mesh=mesh)

    def total(p):
        xs, ts = jax_shard_batch(mesh, jnp.asarray(x), jnp.asarray(t))
        return jtr._loss_components(p, xs, ts, key)["total"]

    l_j, g_j = jax.jit(jax.value_and_grad(total))({"net": pair.jmodel.params, "coeffs": {}})
    draws = jax_bc_ic_points(pair.jpde, key, N)
    return pair, x, t, draws, float(l_j), g_j["net"]


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def ranks(request, sharded_jax, tmp_path_factory):
    """Every case run once on ``world`` gloo ranks: (world, per-rank
    results, the unsharded histories and causal loss, the JAX reference)."""
    world = request.param
    pair, x, t, draws, _, _ = sharded_jax
    state = {k: v.detach().numpy().copy() for k, v in pair.tmodel.module.state_dict().items()}
    causal = _cfg(causal_eps=1.0)
    spec = {"histories": {k: (_cfg(**v), EPOCHS[k]) for k, v in HISTORIES.items()},
            "losses": {"burgers": (_cfg(pair), state, x, t, draws),
                       "causal": (causal, state, x, t, draws)}}
    results = worker.run_ranks(world, tmp_path_factory.mktemp(f"mesh{world}"), spec)
    # The unsharded runs; the padded case at the batch the mesh pads to.
    single = {k: worker.history(_cfg(**v), epochs=EPOCHS[k]) for k, v in HISTORIES.items()
              if k != "padded"}
    single["padded"] = worker.history(_cfg(batch_size=pad_to_multiple(30, world)),
                                      epochs=EPOCHS["padded"])
    single["causal_loss"] = worker.loss_and_grads(causal, state, x, t, draws)
    return world, results, single


@pytest.mark.parametrize("case", sorted(HISTORIES))
def test_histories_match_the_unsharded_run(ranks, case):
    world, results, single = ranks
    got, ref = results[0][f"history/{case}"], single[case]
    assert len(got["train_loss"]) == EPOCHS[case]
    for key in ("train_loss", "val_loss"):
        assert rel_to_max(got[key], ref[key]) < 1e-5, (key, got[key], ref[key])
    for other in results[1:]:  # every rank saw the same run
        mine = other[f"history/{case}"]
        assert mine["train_loss"] == got["train_loss"]
        for k, v in got["params"].items():
            assert np.array_equal(mine["params"][k], v), k


def test_batch_padded_to_a_multiple_of_the_mesh(ranks):
    """tests/test_parallel.py's padding: a batch of 30 over 4 ranks trains
    on 32 rows, 8 per rank (over 2 ranks, 15 each); validation takes the
    whole validation batch on every rank."""
    world, results, single = ranks
    padded = pad_to_multiple(30, world)
    assert padded == {2: 30, 4: 32}[world]
    rows = results[0]["history/padded"]["rows"]
    steps = 64 // padded
    assert rows == ([padded // world] * steps + [128]) * EPOCHS["padded"]
    assert single["padded"]["rows"] == ([padded] * steps + [128]) * EPOCHS["padded"]


def test_sharded_loss_matches_jax_sharded_loss(ranks, sharded_jax):
    world, results, _ = ranks
    pair, _, _, _, l_j, g_j = sharded_jax
    value, grads = results[0]["loss/burgers"]
    assert abs(value - l_j) <= 1e-5 * abs(l_j)
    rels = jax_grad_rels({k: torch.from_numpy(v) for k, v in grads.items()}, g_j)
    assert max(rels.values()) < 1e-4, rels
    for other in results[1:]:
        assert other["loss/burgers"][0] == value


def test_causal_loss_under_the_mesh_equals_unsharded(ranks):
    world, results, single = ranks
    value, grads = results[0]["loss/causal"]
    ref_value, ref_grads = single["causal_loss"]
    assert abs(value - ref_value) <= 1e-5 * abs(ref_value)
    for k, g in grads.items():
        assert rel_to_max(g, ref_grads[k]) < 1e-4, k


def test_make_mesh_sizes(ranks):
    world, results, _ = ranks
    assert [r["size"] for r in results] == [world] * world
    assert [r["rank"] for r in results] == list(range(world))
    assert all(r["too_many"] == f"Requested {world + 1} devices but only {world} available"
               for r in results)
    # make_mesh(1): rank 0 alone forms the mesh.
    assert [r["sub"] for r in results] == [(1, 0)] + [None] * (world - 1)
    assert all(r["jax_loaded"] == [] for r in results)  # the ranks ran the port alone


def test_shard_batch_rows():
    x = torch.arange(12.0).reshape(6, 2)
    t = torch.arange(6.0).reshape(6, 1)
    meshes = [Mesh(size=3, rank=r, device=torch.device("cpu"), group=None) for r in range(3)]
    parts = [shard_batch(m, x, t) for m in meshes]
    assert torch.equal(torch.cat([p[0] for p in parts]), x)
    assert torch.equal(torch.cat([p[1] for p in parts]), t)
    assert batch_sharding(meshes[1], 6) == slice(2, 4)
    with pytest.raises(ValueError, match="pad it"):
        batch_sharding(meshes[0], 7)


def test_mesh_refusals_as_in_jax():
    """An ensemble is refused under a mesh with JAX's message; kernel 1
    forced on under causal weights raises, and stays attached otherwise."""
    mesh = Mesh(size=1, rank=0, device=torch.device("cpu"), group=None)
    pair = burgers_pair(hidden=(8,), mapping=4)
    jmesh = jax_make_mesh()
    for cfg in (pair.jcfg, pair.tcfg):
        cfg.training.ensemble_size = 2
    with pytest.raises(ValueError) as ref:
        JaxTrainer(pair.jmodel, pair.jpde, pair.jcfg, mesh=jmesh)._validate_ensemble()
    with pytest.raises(ValueError) as got:
        PDETrainer(pair.tmodel, pair.tpde, pair.tcfg, mesh=mesh).train(num_epochs=1)
    assert str(got.value) == str(ref.value)
    assert "device-mesh data parallelism unsupported" in str(got.value)
    pair.tcfg.training.ensemble_size = 1
    pair.tcfg.training.fused_residual_kernel = "on"
    assert PDETrainer(pair.tmodel, pair.tpde, pair.tcfg, mesh=mesh).fused_kernel_active
    pair.tcfg.training.causal_eps = 1.0
    with pytest.raises(ValueError, match="causal"):
        PDETrainer(pair.tmodel, pair.tpde, pair.tcfg, mesh=mesh)
    pair.tcfg.training.fused_residual_kernel = "auto"
    assert not PDETrainer(pair.tmodel, pair.tpde, pair.tcfg, mesh=mesh).fused_kernel_active
