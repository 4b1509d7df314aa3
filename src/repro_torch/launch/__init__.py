"""Entry points of the port: serving (``serve``)."""
