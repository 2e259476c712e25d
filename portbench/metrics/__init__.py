"""One reader a metric, found by the metric's name (portbench/cell.py)."""
