from .ip_adapter import IPAdapterPipelineMixin, load_ip_adapter, set_ip_adapter_scale, unload_ip_adapter
