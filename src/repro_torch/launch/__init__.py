"""Entry points of the port: training (``train``), serving (``serve``)
and their meshes (``mesh``)."""
