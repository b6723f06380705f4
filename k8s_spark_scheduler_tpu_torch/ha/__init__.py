"""HA failover fabric (reference ``ha/``): so far only
:mod:`.crashpoint`, the named crash-injection points the preemption
commit (policy/preempt.py) traverses.  Lease election, fencing and
takeover reconciliation are ROADMAP A.6.6; this package imports none of
them.
"""
