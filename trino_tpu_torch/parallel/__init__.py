"""The distributed plane's data movement: exchanges between the tasks of a
distributed plan's fragments (parallel/exchange.py)."""
