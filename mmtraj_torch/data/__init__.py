"""Host and device data transforms of the port."""
