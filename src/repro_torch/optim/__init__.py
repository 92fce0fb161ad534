"""Learning-rate schedules (``schedules``)."""
