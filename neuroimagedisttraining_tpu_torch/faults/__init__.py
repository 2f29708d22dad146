"""The seeded fault schedule (``schedule.py``: crashes, Byzantine value
faults, the comm-level draws, DisPFL's activity draw) and the Byzantine
transforms of the uploads (``adversary.py``)."""
