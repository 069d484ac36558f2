"""Device ms a step of the program's hand-written kernels K1-K5 (by the
names ``port_kernels.json`` lists), over the profiled episode."""

from tmt_bench.trace import device_s_by_name, is_port_kernel, port_kernels


def read(run):
    prof = run["profile"]
    if not prof:
        return None
    port = port_kernels()
    s = sum(t for n, t in device_s_by_name(prof).items() if is_port_kernel(n, port))
    return 1e3 * s / prof["steps"] if s else None
