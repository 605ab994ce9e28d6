"""Architecture and shape configurations (plain data, as in `repro`)."""
