"""The three-term roofline of a traced step, the port of
``repro.roofline``: ``analyze_trace`` reads a ``StepTrace`` where the JAX
package's ``analyze_compiled`` reads a compiled executable."""

from .roofline import (HW, CellReport, analyze_trace, collective_bytes,
                       model_flops, roofline_report)
from .trace import StepTrace, StepTracer

__all__ = ["HW", "CellReport", "analyze_trace", "collective_bytes",
           "model_flops", "roofline_report", "StepTrace", "StepTracer"]
