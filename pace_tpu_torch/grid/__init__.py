"""Gnomonic cubed-sphere grid generation and metric terms."""

from .eta import HybridPressureCoefficients, analytic_hybrid, get_coefficients
from .generation import GridSpec, MetricTerms
from .grid_data import GridData

__all__ = [
    "GridSpec",
    "MetricTerms",
    "GridData",
    "HybridPressureCoefficients",
    "analytic_hybrid",
    "get_coefficients",
]
