"""Map generation CLI tools (reference: python/src/mettagrid/mapgen/tools/)."""
