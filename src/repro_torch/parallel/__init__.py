"""Distribution: logical-axis sharding onto a ``DeviceMesh``, the GPipe
pipeline and the int8 compressed all-reduce."""
