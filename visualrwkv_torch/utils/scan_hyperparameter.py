"""Hyperparameter scan (reference scripts/eval/scan_hyperparameter.py): the
cross product of tasks x hyperparameter values -> invokes the eval CLI per
combination, tagging output files with the value. The port's copy of
``visualrwkv_tpu/utils/scan_hyperparameter.py``: it runs the port's eval CLI
(on CUDA unless ``--extra "--device cpu"``)."""

from __future__ import annotations

import argparse
import itertools
import shlex
import subprocess
import sys


def main(argv=None):
    p = argparse.ArgumentParser("visualrwkv_torch.utils.scan_hyperparameter")
    p.add_argument("--tasks", required=True, help="comma list: name=question_file:image_folder")
    p.add_argument("--param", required=True, help="hyperparameter flag, e.g. num_token_per_image")
    p.add_argument("--values", required=True, help="comma list of values")
    p.add_argument("--model_path", default="")
    p.add_argument("--output_dir", default="scan_out")
    p.add_argument("--extra", default="", help="extra flags passed through to the eval CLI")
    args = p.parse_args(argv)

    tasks = []
    for spec in args.tasks.split(","):
        name, rest = spec.split("=", 1)
        qfile, folder = rest.split(":", 1)
        tasks.append((name, qfile, folder))
    values = args.values.split(",")

    for (name, qfile, folder), value in itertools.product(tasks, values):
        out = f"{args.output_dir}/{name}_{args.param}_{value}.jsonl"
        cmd = [
            sys.executable, "-m", "visualrwkv_torch.evals.cli",
            "--question_file", qfile, "--image_folder", folder,
            "--output_file", out, f"--{args.param}", value,
        ]
        if args.model_path:
            cmd += ["--model_path", args.model_path]
        cmd += shlex.split(args.extra)
        print("+", " ".join(cmd), flush=True)
        subprocess.run(cmd, check=True)


if __name__ == "__main__":
    main()
