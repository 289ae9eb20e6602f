"""The command line of the port (``cli/main.py``)."""
