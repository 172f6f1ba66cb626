"""Framework-level state of the port: the seed chain (:mod:`.random`) and
the flags the profiler reads (:mod:`.flags`)."""
