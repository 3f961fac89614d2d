"""HDFS namenode resolution and failover: a copy of ``petastorm_tpu.hdfs``."""
