"""HVL007 clean: every key built by the port's typed registry."""
from horovod_tpu_torch.common import kv_keys


def announce(client, host, slot):
    client.put_json(kv_keys.drain(host, slot), {"ts": 0})


def gc(kv, gen):
    kv.delete_prefix(kv_keys.worker_state_prefix(gen))


def stop(client):
    client.put_json(kv_keys.serve_stop(), {"ts": 0})
    return "notify"  # a bare word outside a KV accessor is not a key
