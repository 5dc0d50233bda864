"""Multi-process training: the process group (``distributed``) and the mesh,
placement rules and wrappers (``mesh``)."""
