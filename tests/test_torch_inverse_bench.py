"""The port's inverse harness and benchmark CLI against pinnrl_tpu's.

The recipes and the configs they build equal the JAX package's; a run cut
to CPU size (Fourier 16x2, mapping 8, 256 points, 64 observations, by
monkeypatching the recipes as tests/test_time_marching_and_inverse_bench.py
runs the JAX harness short) gives the JAX harness's result fields, relative
error and CSV; the CLI prints, writes and appends its CSV, and the harnesses
that are not ported raise naming their items.
"""

import numpy as np
import pytest

from pinnrl_tpu.benchmarks import cli as jax_cli
from pinnrl_tpu.benchmarks import inverse as jax_inverse
from pinnrl_tpu_torch.benchmarks import cli, inverse


@pytest.mark.parametrize("key", ["heat", "black_scholes"])
def test_recipes_and_configs_equal_jax(monkeypatch, key):
    """RECIPES field for field, and the Config run_inverse trains: the JAX
    harness's captured by replacing its trainer."""
    assert inverse.RECIPES[key] == jax_inverse.RECIPES[key]
    seen = {}

    class Capture:
        def __init__(self, model, pde, cfg):
            seen["cfg"] = cfg
            self.pde = pde

        def train(self, seed=0):
            return {"identified_parameters": {k: 1.0 for k in self.pde.trainable_parameters}}

    monkeypatch.setattr(jax_inverse, "PDETrainer", Capture)
    jax_inverse.run_inverse(key, seed=0, epochs=7)
    a = seen["cfg"].to_dict()
    b = inverse.build_inverse_config(key, epochs=7, device="cpu").to_dict()
    assert b.pop("device") == "cpu"
    a.pop("device")
    assert a == b


def _tiny(monkeypatch):
    tiny = {}
    for key, recipe in inverse.RECIPES.items():
        r = dict(recipe)
        r["model"] = {**recipe["model"], "hidden_dims": [16, 16], "mapping_size": 8}
        r["training"] = {**recipe["training"], "num_collocation_points": 256, "batch_size": 128,
                         "num_boundary_points": 32, "num_initial_points": 32}
        r["obs"] = {**recipe["obs"], "num_points": 64}
        tiny[key] = r
    monkeypatch.setattr(inverse, "RECIPES", tiny)


@pytest.fixture
def results(monkeypatch):
    _tiny(monkeypatch)
    return inverse.run_inverse("black_scholes", seed=1, epochs=2, device="cpu")


def test_result_fields_and_rel_error(results):
    sigma, r = results
    assert (sigma.pde, sigma.parameter, r.parameter) == ("black_scholes", "sigma", "r")
    assert sigma.true_value == pytest.approx(0.2) and r.true_value == pytest.approx(0.05)
    assert sigma.initial_guess == pytest.approx(0.4) and r.initial_guess == pytest.approx(0.02)
    for res in results:
        assert np.isfinite(res.identified) and res.epochs == 2 and res.seed == 1
        assert res.noise == 0.01 and res.wall_time_s > 0
        assert res.rel_error == pytest.approx(
            abs(res.identified - res.true_value) / abs(res.true_value), rel=1e-9)
    assert sigma.identified >= 0.0  # canonical


def test_csv_matches_jax_format(results):
    jres = [jax_inverse.InverseResult(**vars(r)) for r in results]
    assert inverse.results_to_csv(results) == jax_inverse.results_to_csv(jres)
    lines = inverse.results_to_csv(results).strip().split("\n")
    assert lines[0] == ("pde,parameter,true_value,initial_guess,identified,rel_error,"
                        "epochs,noise,wall_time_s,seed")
    assert lines[1].startswith("black_scholes,sigma,0.2,0.4,") and len(lines) == 3


def test_inverse_cli_prints_and_appends(monkeypatch, tmp_path, capsys):
    _tiny(monkeypatch)
    out = tmp_path / "inv.csv"
    for seed in (0, 1):
        assert cli.main(["inverse", "--pde", "heat", "--epochs", "2", "--seed", str(seed),
                         "--device", "cpu", "--csv", str(out)]) == 0
    text = capsys.readouterr().out
    assert "identified" in text and "alpha" in text
    lines = out.read_text().strip().split("\n")
    assert lines[0].startswith("pde,parameter,true_value,initial_guess")
    assert [ln.split(",")[-1] for ln in lines[1:]] == ["0", "1"]


def test_write_csv_appends_as_jax(tmp_path, capsys):
    text = "a,b\n1,2\n"
    for mod, name in ((cli, "t.csv"), (jax_cli, "j.csv")):
        mod._write_csv(str(tmp_path / name), text)
        mod._write_csv(str(tmp_path / name), text.replace("1,2", "3,4"))
    assert (tmp_path / "t.csv").read_text() == (tmp_path / "j.csv").read_text() == "a,b\n1,2\n3,4\n"


@pytest.mark.parametrize("argv,item", [
    (["convergence", "--pde", "kdv", "--time-marching", "2", "--device", "cpu"], 13),
])
def test_unported_subcommands_raise(argv, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP item {item}"):
        cli.main(argv)


@pytest.mark.parametrize("argv,header", [
    (["fdm", "--pde", "heat", "--nx", "11"], "pde,scheme,stability,l2_error"),
    (["sampling", "--pde", "burgers", "--strategies", "uniform", "--epochs", "2", "--batch", "16"],
     "pde,architecture,strategy,final_loss"),
    (["operator", "--dataset", "synthetic_heat_2d", "--gridded", "--transfer", "64", "--epochs",
      "2"], "dataset,architecture,mode,epochs"),
])
def test_ported_subcommands_run(argv, header, tmp_path, capsys):
    """The subcommands that raised before they were ported now run on the
    CPU and write their CSV with the JAX package's header."""
    out = tmp_path / "out.csv"
    assert cli.main(argv + ["--device", "cpu", "--csv", str(out)]) == 0
    assert out.read_text().startswith(header) and "CSV written" in capsys.readouterr().out


def test_convergence_subcommand_runs_the_port(monkeypatch, tmp_path):
    from pinnrl_tpu_torch.benchmarks import convergence

    calls = []

    def fake(key, seed=0, epochs=None, device="cuda"):
        calls.append((key, seed, epochs, device))
        return convergence.ConvergenceResult(key, "fourier", epochs, 1e-3, 2e-3, 1e-4, 1.0, 10.0, seed)

    monkeypatch.setattr(convergence, "run_convergence", fake)
    assert cli.main(["convergence", "--pde", "heat", "--epochs", "3", "--device", "cpu",
                     "--csv", str(tmp_path / "c.csv")]) == 0
    assert calls == [("heat", 0, 3, "cpu")]
    assert (tmp_path / "c.csv").read_text().startswith("pde,architecture,epochs,rel_l2")
