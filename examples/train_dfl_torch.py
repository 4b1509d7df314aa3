"""End-to-end DFL training driver example on the PyTorch port: the
reference's ``examples/train_dfl.py`` legs through
``python -m repro_torch.launch.train``.

Runs the full stack — model zoo -> worker-stacked [W, P] matrix ->
masked-tau local SGD -> matching-wise gossip -> FedHP controller ->
checkpointing — on a mesh of 4 slots of one device (``REPRO_DEVICES=4``,
``--workers 4``: W = 4 on a ``(data, model) = (4, 1)`` mesh), with a
kill-and-resume leg exercising the elastic restore:

    PYTHONPATH=src python examples/train_dfl_torch.py --device cpu

(drop ``--device cpu`` to run on the card). The reference's own example
sets 8 devices, and so a model axis of 2, which the port refuses
(ROADMAP.md queue 1, item 4).
"""
import argparse
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(args, env):
    cmd = [sys.executable, "-m", "repro_torch.launch.train"] + args
    print("+", " ".join(cmd), flush=True)
    subprocess.run(cmd, check=True, env=env)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU; the card otherwise")
    device = ap.parse_args().device
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(REPO, "src")] +
        [p for p in [env.get("PYTHONPATH")] if p])
    env["REPRO_DEVICES"] = "4"
    common = ["--arch", "smollm-360m", "--smoke", "--workers", "4"]
    if device:
        common += ["--device", device]
    with tempfile.TemporaryDirectory() as ckdir:
        # leg 1: 6 rounds with checkpoints every 3
        run(common + ["--steps", "6", "--checkpoint-dir", ckdir,
                      "--checkpoint-every", "3"], env)
        # leg 2: resume from the checkpoint and continue to 10
        run(common + ["--steps", "10", "--checkpoint-dir", ckdir,
                      "--resume"], env)
    print("train + checkpoint + elastic resume: OK")


if __name__ == "__main__":
    main()
