"""Model assemblies and the ``--arch`` registry."""
