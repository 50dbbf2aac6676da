"""int8_conv_roofline.serve: the int8 convolutions' least time (the
reference's conv shapes: bytes at the peak bandwidth or operations at the
peak int8 rate, the larger, summed) over the device time launched inside
the program's int8 conv modules, in % (device trace)."""


def read(run):
    if run.trace is None or run.kind != "serve" or not run.requests:
        return None
    s = run.trace.device_s(lambda r: "portbench.int8_conv" in r)
    if not s:
        return None
    return run.int8_least_s * run.requests / s * 100
