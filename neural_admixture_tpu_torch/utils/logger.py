"""Stdout logging in the reference CLI's format (one message per line)."""
import logging
import sys

_CONFIGURED = False


def setup_logging(level: int = logging.INFO) -> None:
    global _CONFIGURED
    if _CONFIGURED:
        return
    logging.basicConfig(stream=sys.stdout, level=level, format="%(message)s")
    _CONFIGURED = True


log = logging.getLogger("neural_admixture_tpu_torch")
