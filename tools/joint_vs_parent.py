"""The smoke's joint path (``chip_smoke.joint_path``) of this checkout
against another checkout's, on one card, in turns: parent, this, this,
parent, each in a process of its own.

    python3 -m tools.joint_vs_parent --parent DIR

``DIR`` holds another checkout (e.g. the parent commit, unpacked with
``git archive HEAD | tar -x -C build/parent``). Each run prints one JSON
line: per size (64x64, 480x640) the ms per step (host clock around
synchronised steps), the device's busy ms per step and idle share from
``torch.profiler``, and the peak memory at 480x640; a last line gives the
mean of each package's two runs.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

_RUN = (
    "import json, sys; sys.path.insert(0, '.'); import chip_smoke as S; "
    "r = S.joint_path('cuda'); "
    "print('RESULT ' + json.dumps({k: {"
    "'ms_per_step': r[k]['ms_per_step'], "
    "'device_busy_ms_per_step': r[k]['profile'].get("
    "'device_busy_ms_per_step'), "
    "'device_idle_share': r[k]['profile'].get('device_idle_share'), "
    "'peak_memory_gib': r[k].get('peak_memory_gib')} "
    "for k in ('small', 'large')}))")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True)
    args = ap.parse_args(argv)
    here = Path(__file__).resolve().parent.parent
    runs = {"parent": [], "this": []}
    for name, root in (("parent", args.parent), ("this", here),
                       ("this", here), ("parent", args.parent)):
        out = subprocess.run([sys.executable, "-c", _RUN], cwd=root,
                             capture_output=True, text=True, timeout=900)
        line = [ln for ln in out.stdout.splitlines()
                if ln.startswith("RESULT ")]
        if out.returncode != 0 or not line:
            print(out.stdout[-2000:], out.stderr[-4000:], file=sys.stderr)
            return 1
        res = json.loads(line[0][len("RESULT "):])
        runs[name].append(res)
        print(json.dumps({"package": name, "root": str(root), **res}),
              flush=True)
    mean = {name: {size: sum(r[size]["ms_per_step"] for r in rs) / len(rs)
                   for size in ("small", "large")}
            for name, rs in runs.items()}
    print(json.dumps({"mean_ms_per_step": mean}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
