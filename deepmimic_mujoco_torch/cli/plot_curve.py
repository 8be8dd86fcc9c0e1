#!/usr/bin/env python3
"""Learning-curve plot of the monitor CSVs under a log directory (port of
``deepmimic_mujoco_tpu/cli/plot_curve.py``).  Reads files and writes a
figure; it touches no device.

    python -m deepmimic_mujoco_torch.cli.plot_curve --log-dir log_tmp \\
        --out figures/DeepMimic-reward.svg
"""

from __future__ import annotations

import argparse

from deepmimic_mujoco_torch.utils.plotting import plot_curve


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--log-dir", default="log_tmp")
    p.add_argument("--out", default=None)
    p.add_argument("--env-name", default="DeepMimic")
    args = p.parse_args(argv)

    out = plot_curve(args.log_dir, args.out, args.env_name)
    print("wrote", out)
    return out


if __name__ == "__main__":
    main()
