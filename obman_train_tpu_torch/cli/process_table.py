"""Cross-experiment results table CLI (the JAX package's
``cli/process_table.py``; reference: scripts/process_table.py). Host only.

  python -m obman_train_tpu_torch.cli.process_table --exp_dirs a b c --out res.html
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--exp_dirs", nargs="+", required=True)
    parser.add_argument("--out", default="results_table.html")
    parser.add_argument("--split", default="val")
    parser.add_argument("--metrics", nargs="+", default=None)
    args = parser.parse_args(argv)

    from obman_train_tpu_torch.utils.tables import process_table

    md = process_table(args.exp_dirs, args.out, args.split, args.metrics)
    print(md)
    print(f"\nWrote {args.out}")


if __name__ == "__main__":
    main()
