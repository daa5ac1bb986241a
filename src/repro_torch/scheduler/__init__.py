"""Scheduler pieces the port has so far: the clock, latency windows, the
signals type the fusion policy reads, the shared service-time estimate, SLO
class lanes and the shed error the continuous batcher uses."""
