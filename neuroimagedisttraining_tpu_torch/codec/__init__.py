"""The model-update wire codec: the spec, the frames and their byte count
on the host (``wire.py``), the value transform the engines apply on the
device (``device.py``)."""
