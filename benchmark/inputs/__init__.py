"""The inputs of a run, made on the device from its seed."""
