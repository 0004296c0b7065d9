"""HVL007 trigger: raw KV key construction in every flagged form."""


def announce(client, host, slot):
    # f-string with a registered family prefix
    client.put_json(f"drain/{host}/{slot}", {"ts": 0})


def gc(kv, gen):
    # plain literal participating in concatenation
    kv.delete_prefix("worker_state/g" + str(gen) + "/")


def stop(client):
    # singleton key passed straight to a KV accessor
    client.put_json("serve_stop", {"ts": 0})
