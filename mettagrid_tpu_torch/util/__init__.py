"""Host utilities (reference: mettagrid_tpu/util/): URI file IO
(``file``) and episode stats sinks (``stats_writer``)."""
