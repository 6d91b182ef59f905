"""Runtime sanitizers (`sanitize.py`): the device-to-host guard, the QoS
NaN check and the ownership assertions."""
