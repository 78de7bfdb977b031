"""`python3 -X pycache_prefix=port_bench/_pycache -m port_bench --workload
<name> --seed <n> --seconds <s> --trace <0|1>`: one run of one cell."""

import sys
import time

_T_START = time.perf_counter()
# The bytecode cache inside the checkout (-X pycache_prefix): where the
# environment forbids writing bytecode (PYTHONDONTWRITEBYTECODE), every
# process compiles torch's modules anew, ~10 s of each run's set-up.
sys.dont_write_bytecode = False

from port_bench.run import main  # noqa: E402

raise SystemExit(main(t_start=_T_START))
