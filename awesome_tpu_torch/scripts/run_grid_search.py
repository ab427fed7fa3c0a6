"""Grid-search fan-out; counterpart of ``scripts/run_grid_search.py``
(spec: reference `scripts/run_grid_search.py:32-60`).

    python -m awesome_tpu_torch.scripts.run_grid_search \\
        --config-path base.yaml \\
        --grid '{optimizer_args.lr: [0.01, 0.02], num_epochs: [100, 300]}' \\
        [--serial | --job-file out/JobFile.py] [--shards N --shard-id I]

The job file's jobs run ``python -m awesome_tpu_torch.run``; ``--serial``
trains every child in this process, on the base config's device.
"""
import argparse


def main(argv=None) -> None:
    import yaml

    from awesome_tpu_torch.runner.config import AwesomeConfig
    from awesome_tpu_torch.runner.multi import GridSearchRunner, shard_jobs

    p = argparse.ArgumentParser()
    p.add_argument("--config-path", type=str, default=None)
    p.add_argument("--grid", type=str, required=True)
    p.add_argument("--output-dir", type=str, default="./grid")
    p.add_argument("--serial", action="store_true")
    p.add_argument("--job-file", type=str, default=None)
    p.add_argument("--shards", type=int, default=1)
    p.add_argument("--shard-id", type=int, default=0)
    args = p.parse_args(argv)

    base = (AwesomeConfig.load(args.config_path) if args.config_path
            else AwesomeConfig())
    base.prepare()
    grid = yaml.safe_load(args.grid)
    runner = GridSearchRunner(base, grid, output_dir=args.output_dir)
    runner.build()
    if args.serial:
        for i, m in enumerate(runner.run_serial()):
            print(i, m)
    else:
        path = runner.create_job_file(args.job_file)
        jobs = runner.create_jobs()
        mine = shard_jobs(jobs, args.shards, args.shard_id)
        print(f"wrote {path} ({len(jobs)} jobs, {len(mine)} in this shard)")


if __name__ == "__main__":
    main()
