"""setup_s: seconds from the start of the process to the start of the
window (import, library load, data, operator, preconditioner where the
traffic prebuilds it, warm-up; in a checkout's first run, the build)."""

UNIT = "s"


def read(run):
    return run.setup_s
