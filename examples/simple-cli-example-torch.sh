#!/bin/sh
# The README walkthrough on the PyTorch port (sda_tpu_torch.server_cli and
# sda_tpu_torch.cli): a recipient, three clerks, three participants, 10-dim
# vectors mod 433, 3-way additive split. Expected reveal: 0 2 2 4 4 6 6 8 8 10.
# Needs libsodium; run from the repository root:
#     sh examples/simple-cli-example-torch.sh [data dir] [port]
set -e

DATA=${1:-tmp/simple-data-torch}
PORT=${2:-18889}
rm -rf "$DATA"
mkdir -p "$DATA"

python -m sda_tpu_torch.server_cli --jfs "$DATA/server" httpd -b 127.0.0.1:$PORT &
SERVER_PID=$!
trap 'kill $SERVER_PID 2>/dev/null || true' EXIT
sleep 1

sda() { python -m sda_tpu_torch.cli -s http://127.0.0.1:$PORT "$@"; }

# the recipient and the committee clerks each register an identity AND a
# signed encryption key (shares will be sealed to those keys)
for i in recipient clerk-1 clerk-2 clerk-3; do
    sda -i "$DATA/agent/$i" agent create
    sda -i "$DATA/agent/$i" agent keys create
done

# participants only ever encrypt TO others, so a bare identity suffices
for i in part-1 part-2 part-3; do
    sda -i "$DATA/agent/$i" agent create
done

AGGID=ad3142d8-9a83-4f40-a64a-a8c90b701bde
RECIPIENT_KEY_ID=$(sda -i "$DATA/agent/recipient" agent keys show | head -1)

sda -i "$DATA/agent/recipient" aggregations create --id $AGGID "aggro" 10 433 "$RECIPIENT_KEY_ID" 3
sda -i "$DATA/agent/recipient" aggregations begin $AGGID

sda -i "$DATA/agent/part-1" participate $AGGID 0 1 2 3 4 5 6 7 8 9
sda -i "$DATA/agent/part-2" participate $AGGID 0 0 0 0 0 0 0 0 0 0
sda -i "$DATA/agent/part-3" participate $AGGID 0 1 0 1 0 1 0 1 0 1

sda -i "$DATA/agent/recipient" aggregations end $AGGID

for i in recipient clerk-1 clerk-2 clerk-3; do
    sda -i "$DATA/agent/$i" clerk --once
done

sda -i "$DATA/agent/recipient" aggregations reveal $AGGID
