"""Device ms a step of every kernel that is not one of the program's
hand-written kernels (K1-K5, by the names ``port_kernels.json`` lists):
the plain torch ops of ``ops/runs.py``, ``lines.py``, ``board_ops.py``,
``random.py`` and the rest, over the profiled episode."""

from tmt_bench.trace import device_s_by_name, is_kernel, is_port_kernel, port_kernels


def read(run):
    prof = run["profile"]
    if not prof or not prof["ops"]:
        return None
    port = port_kernels()
    s = sum(t for n, t in device_s_by_name(prof).items() if is_kernel(n) and not is_port_kernel(n, port))
    return 1e3 * s / prof["steps"]
