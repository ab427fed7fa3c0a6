"""Run or list many configs from a directory; counterpart of
``scripts/run_multi_config.py`` (spec: reference
`scripts/run_multi_config.py:32-60`).

    python -m awesome_tpu_torch.scripts.run_multi_config \\
        --config-dir configs/ [--serial] [--shards N --shard-id I]

Each job is ``python -m awesome_tpu_torch.run --config-path <yaml>``;
``--serial`` runs them one after another, else they are printed.
"""
import argparse
import subprocess
import sys


def main(argv=None) -> None:
    from awesome_tpu_torch.runner.multi import MultiConfigRunner, shard_jobs

    p = argparse.ArgumentParser()
    p.add_argument("--config-dir", type=str, required=True)
    p.add_argument("--serial", action="store_true")
    p.add_argument("--shards", type=int, default=1)
    p.add_argument("--shard-id", type=int, default=0)
    args = p.parse_args(argv)

    runner = MultiConfigRunner(args.config_dir)
    jobs = shard_jobs(runner.create_jobs(), args.shards, args.shard_id)
    for script, argv_job in jobs:
        if args.serial:
            subprocess.run([sys.executable, *script.split(), *argv_job],
                           check=True)
        else:
            print(script, " ".join(argv_job))


if __name__ == "__main__":
    main()
