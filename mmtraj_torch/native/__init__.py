"""Native host code of the port: the annotation parser (``fastparse.cpp``)."""
