"""Sum a pytest junit XML's test times per test file and print the slowest.

    python3 scripts/junit_file_times.py RUN.xml [--top 25] [--files a.py b.py]

Under ``--dist loadfile`` each file runs on one xdist worker, so a file's
sum is the time it held that worker (setup, call and teardown of each of
its tests; collection not included). Prints the suite's counts and time,
then the ``--top`` files by summed seconds as ``name seconds; ...``, the
sums over the port's files (``test_torch_*``) and over the others, and
the sum over the ``--files`` named, each as one line.
"""
import argparse
import collections
import xml.etree.ElementTree as ET


def file_times(path):
    """{test file name: summed seconds} of a junit XML."""
    out = collections.Counter()
    for case in ET.parse(path).getroot().iter("testcase"):
        parts = case.get("classname", "").split(".")
        name = next((p for p in parts if p.startswith("test_")), None)
        if name is not None:
            out[name + ".py"] += float(case.get("time") or 0.0)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("xml")
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--files", nargs="*", default=[])
    args = ap.parse_args(argv)
    root = ET.parse(args.xml).getroot()
    suite = root if root.tag == "testsuite" else root.find("testsuite")
    print("suite", {k: suite.get(k) for k in
                    ("tests", "errors", "failures", "skipped", "time")})
    times = file_times(args.xml)
    print("; ".join(f"{k} {v:.1f}" for k, v in times.most_common(args.top)))
    port = sum(v for k, v in times.items() if k.startswith("test_torch_"))
    print(f"port files {port:.1f}; other files "
          f"{sum(times.values()) - port:.1f}")
    if args.files:
        print(f"named files {sum(times[f] for f in args.files):.1f}")


if __name__ == "__main__":
    main()
