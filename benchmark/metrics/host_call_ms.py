"""host_call_ms: the median host time from call to return of the transform
entry, for calls each made after a synchronise: the host's cost to
dispatch one call (the pipeline layer and the kernel wrappers)."""


def read(ctx):
    return ctx["work"].get("host_call_ms")
