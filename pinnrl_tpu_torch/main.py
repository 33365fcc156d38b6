"""``pinnrl-dashboard-torch`` entry point: serve the port's dashboard.

    python -m pinnrl_tpu_torch.main [--port 8050] [--results-dir experiments]
        [--no-browser] [--device cuda|cpu]

The solution explorer and the runs launched from the page use ``--device``
(the card unless "cpu").
"""

from __future__ import annotations

import argparse
import sys
import webbrowser


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="pinnrl-dashboard-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--port", type=int, default=8050)
    p.add_argument("--results-dir", default="experiments")
    p.add_argument("--no-browser", action="store_true")
    p.add_argument("--device", default="cuda", help="cuda | cpu")
    args = p.parse_args(argv)

    from pinnrl_tpu_torch.dashboard import run_dashboard

    if not args.no_browser:
        try:
            webbrowser.open(f"http://localhost:{args.port}")
        except Exception:
            pass
    run_dashboard(results_dir=args.results_dir, port=args.port, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
