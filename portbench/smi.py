"""The card's name, power limit, SM clock and power draw from ``nvidia-smi``.

``card_line`` is a frozen copy of ``chip_smoke.py``'s; ``Sampler`` runs the
query and the parsing of its ``sample_smi`` (every 100 ms) over a window the
caller opens and closes, in place of a function that it times. A machine
without ``nvidia-smi`` gives no samples and no card line, never an error:
the readings go on the run's log lines, not into its metrics.
"""

import shutil
import subprocess


def card_line() -> str:
    """``name, power.limit`` of the first card, or "" without nvidia-smi."""
    if shutil.which("nvidia-smi") is None:
        return ""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


class Sampler:
    """``nvidia-smi`` sampling the SM clock (MHz) and power draw (W) every
    100 ms between :meth:`start` and :meth:`stop`; ``stop`` returns the
    samples as ``(mhz, watts)`` pairs and waits for the process to end."""

    def __init__(self):
        self._proc = None

    def start(self):
        if shutil.which("nvidia-smi") is None:
            return
        self._proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)

    def stop(self) -> list:
        if self._proc is None:
            return []
        self._proc.terminate()
        try:
            out = self._proc.communicate(timeout=30)[0]
        except subprocess.TimeoutExpired:
            self._proc.kill()
            out = self._proc.communicate()[0]
        self._proc = None
        samples = []
        for line in out.splitlines():
            parts = [p.strip() for p in line.split(",")]
            if len(parts) == 2:
                try:
                    samples.append((float(parts[0]), float(parts[1])))
                except ValueError:
                    continue
        return samples
