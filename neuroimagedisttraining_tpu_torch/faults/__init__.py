"""The seeded fault schedule (``schedule.py``: crashes, Byzantine value
faults, the comm-level draws, DisPFL's activity draw), the Byzantine
transforms of the uploads (``adversary.py``) and the schedule applied to
a control-plane transport (``chaos.py``, ``FaultyCommManager``)."""
