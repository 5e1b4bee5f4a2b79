"""Test-seconds per test file from a pytest junit XML, largest first.

    python3 junit_times.py RUN.xml [BEFORE.xml] [--match test_torch_]

The sum of every test case's time in each file (setup and teardown of its
fixtures included, as pytest reports them), the file's count of passes, and
the run's totals. With a second XML, the two runs side by side (the first
taken as "after"). Under xdist the sums add up across workers, so they can
exceed the run's wall time. A file past ~120 test-seconds on its own is the
one to look at first: under ``-n 6 --dist loadfile`` it sits on one worker.
"""

import argparse
import xml.etree.ElementTree as ET
from collections import defaultdict


def file_times(path):
    """{file: [seconds, passed, cases]} and the run's wall time."""
    root = ET.parse(path).getroot()
    suite = root if root.tag == "testsuite" else root.find("testsuite")
    out = defaultdict(lambda: [0.0, 0, 0])
    for case in suite.iter("testcase"):
        name = case.get("classname", "").split(".")
        # "tests.test_x.TestClass" -> tests/test_x.py
        parts = [p for p in name if p]
        while parts and not parts[-1].startswith("test_"):
            parts.pop()
        key = "/".join(parts) + ".py" if parts else case.get("file", "?")
        row = out[key]
        row[0] += float(case.get("time", 0.0))
        row[2] += 1
        if not any(case.find(t) is not None for t in ("failure", "error", "skipped")):
            row[1] += 1
    return dict(out), float(suite.get("time", 0.0))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("after")
    ap.add_argument("before", nargs="?")
    ap.add_argument("--match", default="", help="only files whose path holds this")
    args = ap.parse_args(argv)
    after, after_wall = file_times(args.after)
    before, before_wall = file_times(args.before) if args.before else ({}, None)
    files = sorted((f for f in set(after) | set(before) if args.match in f),
                   key=lambda f: -after.get(f, before.get(f, [0.0]))[0])
    head = f"{'file':60s} {'after s':>9s} {'passed':>6s}"
    if args.before:
        head += f" {'before s':>9s} {'passed':>6s}"
    print(head)
    for f in files:
        a = after.get(f, [float("nan"), 0, 0])
        line = f"{f:60s} {a[0]:9.1f} {a[1]:6d}"
        if args.before:
            b = before.get(f, [float("nan"), 0, 0])
            line += f" {b[0]:9.1f} {b[1]:6d}"
        print(line)
    tot = [sum(after[f][i] for f in files if f in after) for i in (0, 1)]
    line = f"{'total (' + str(len(files)) + ' files)':60s} {tot[0]:9.1f} {tot[1]:6d}"
    if args.before:
        btot = [sum(before[f][i] for f in files if f in before) for i in (0, 1)]
        line += f" {btot[0]:9.1f} {btot[1]:6d}"
    print(line)
    print(f"run wall s: after {after_wall}" + (f", before {before_wall}" if args.before else ""))


if __name__ == "__main__":
    main()
