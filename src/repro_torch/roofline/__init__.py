"""Roofline terms and the analytic cost model on the H100's constants
(``repro.roofline``)."""
