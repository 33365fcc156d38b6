"""Training dashboard: a stdlib ``http.server`` backend serving JSON APIs
over the experiment-directory file protocol, and one self-contained
HTML/JS page (SVG loss curves, canvas heatmaps, 10 s polling). Runs are
launched as detached ``pinnrl_tpu_torch.training.train`` subprocesses, so
the UI stays crash-isolated."""

from pinnrl_tpu_torch.dashboard.server import DashboardServer, run_dashboard  # noqa: F401
