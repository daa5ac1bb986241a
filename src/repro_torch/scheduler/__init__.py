"""Scheduler pieces the platform core needs: the clock, latency windows and
the signals type the fusion policy reads."""
