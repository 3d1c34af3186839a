#!/usr/bin/env python3
"""Worker time of a Tier-1 run by test file, from its junit XML.

    python3 tier1_times.py RUN.xml [BASE.xml]

Prints the run's worker-seconds in all, in the port's test files
(``tests/test_torch_*.py``) and in the others, then the heaviest files
(beside BASE's seconds when given). A run made with ``JAX_LOG_COMPILES=1``
and ``-o junit_logging=all`` also gives each file's XLA compilations from
its captured stderr: their number and seconds, and how many took under
0.3 s (eager JAX compiles one such kernel a primitive).
"""
from __future__ import annotations

import collections
import re
import sys
import xml.etree.ElementTree as ET

_COMPILE = re.compile(r'Finished XLA compilation of \S+ in ([0-9.e-]+) sec')


def file_times(path):
    """{test file: [worker-seconds, compiles, compile s, small compiles]}."""
    out = collections.defaultdict(lambda: [0.0, 0, 0.0, 0])
    for case in ET.parse(path).iter('testcase'):
        row = out[case.get('classname')]
        row[0] += float(case.get('time') or 0.0)
        err = ''.join(e.text or '' for e in case if e.tag == 'system-err')
        for sec in map(float, _COMPILE.findall(err)):
            row[1] += 1
            row[2] += sec
            row[3] += sec < 0.3
    return out


def main(argv) -> int:
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    run = file_times(argv[0])
    base = file_times(argv[1]) if len(argv) > 1 else {}
    port = sum(r[0] for f, r in run.items() if 'test_torch_' in f)
    total = sum(r[0] for r in run.values())
    print(f'worker-seconds {total:.1f}: port {port:.1f}, others '
          f'{total - port:.1f}')
    for f, (sec, n, csec, small) in sorted(run.items(),
                                           key=lambda kv: -kv[1][0])[:40]:
        was = f' (base {base[f][0]:.1f})' if f in base else ''
        comp = f'; {n} compiles, {csec:.1f} s, {small} small' if n else ''
        print(f'{sec:8.1f}{was} {f}{comp}')
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
