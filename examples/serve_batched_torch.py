"""Batched serving on the PyTorch port: prefill and greedy decode with
KV / recurrent caches across three model families (dense GQA, MoE,
hybrid SSM), at their smoke configs — the port's twin of
``examples/serve_batched.py``.

    PYTHONPATH=src python examples/serve_batched_torch.py --device cpu

Without ``--device`` it serves on the card.
"""
import argparse
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' to serve on the CPU; the card otherwise")
    args = ap.parse_args(argv)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    for arch in ("smollm-360m", "olmoe-1b-7b", "zamba2-7b"):
        cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
               arch, "--smoke", "--batch", "2", "--prompt-len", "16",
               "--gen", "6"]
        if args.device:
            cmd += ["--device", args.device]
        print("+", " ".join(cmd))
        subprocess.run(cmd, check=True, env=env)


if __name__ == "__main__":
    main()
